"""Host-side data code of the port: numpy only."""
