"""Data of the port: the deterministic synthetic token pipeline."""

from .pipeline import SyntheticDataset  # noqa: F401
