"""The training step of the port: optimizer, schedule and trainer."""
