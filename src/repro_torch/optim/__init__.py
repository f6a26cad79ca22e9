"""Optimizer of the port: AdamW with global-norm clipping, a cosine
schedule and optional bfloat16 moments, and int8 error-feedback gradient
compression for cross-pod DCN sync."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm  # noqa
from .compress import int8_compress, int8_decompress  # noqa
