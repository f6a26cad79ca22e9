"""Checkpointing of the port: the crash-safe checkpoint store."""

from .store import CheckpointStore  # noqa: F401
