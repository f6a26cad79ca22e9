"""Optimizer of the port: AdamW with global-norm clipping, a cosine
schedule and optional bfloat16 moments."""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm  # noqa
