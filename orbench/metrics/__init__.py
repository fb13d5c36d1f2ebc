"""Metric readers: ``metrics/<name>.py`` has ``read(run)`` → the metric's
value from a finished run (``harness.Run``), or None where the run has
nothing to read, and the harness leaves the metric out."""
