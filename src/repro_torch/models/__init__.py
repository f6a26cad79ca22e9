"""Model substrate of the port: the dense and hybrid decoder LMs for
training and serving."""

from .common import ModelConfig  # noqa: F401
from .lm import LM, HybridLM, build_model  # noqa: F401
