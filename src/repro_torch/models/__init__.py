"""Model substrate of the port: the dense decoder LM for training and
serving."""

from .common import ModelConfig  # noqa: F401
from .lm import LM, build_model  # noqa: F401
