"""Model substrate of the port: the dense, audio, moe, vlm, hybrid and
rwkv6 decoder LMs for training and serving."""

from .common import ModelConfig  # noqa: F401
from .lm import LM, HybridLM, MoeLM, RwkvLM, VlmLM, build_model  # noqa: F401
