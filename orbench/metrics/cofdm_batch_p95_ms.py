"""95th percentile of every batch's time in the traced window (spans on:
the device is synchronised at each layer span's edges)."""

from .batch_p95_ms import read  # noqa: F401
