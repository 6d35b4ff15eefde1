"""Training: schedules and the Trainer."""
