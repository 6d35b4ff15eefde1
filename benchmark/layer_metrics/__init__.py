"""Per-layer metric readers: ``<metric name>.py`` a metric, each with
``read(reading) -> float | None``. ``_common`` holds their arithmetic."""
