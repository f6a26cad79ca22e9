"""Serving of the port: single-host batched generation, the tensor-parallel
engine in its local mode, and the continuous-batching request scheduler."""

from .engine import ServeEngine  # noqa: F401
from .scheduler import Request, RequestScheduler  # noqa: F401
from .tp import TPServeEngine  # noqa: F401
