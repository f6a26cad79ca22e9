"""Architecture registry of the port: the configurations it can serve and
train.

The port's own copies of the ``repro.configs`` modules it supports. An arch
enters this registry when its family and kernels are ported.
"""

from __future__ import annotations

import importlib
from repro_torch.models.common import ModelConfig

ARCH_MODULES = {
    "yi-6b": "yi_6b",
    # the paper's own evaluation model
    "gpt2-124m": "gpt2_124m",
    "zamba2-1.2b": "zamba2_1p2b",
    "rwkv6-3b": "rwkv6_3b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "llama4-maverick-400b-a17b": "llama4_maverick",
}


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port supports "
                       f"{sorted(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")


def get_config(arch: str, **overrides) -> ModelConfig:
    return _module(arch).config(**overrides)


def smoke_config(arch: str, **overrides) -> ModelConfig:
    return _module(arch).smoke_config(**overrides)
