"""Architecture registry of the port and the assigned input shapes: the
reference's 10 archs x 4 shapes, plus gpt2-124m.

The port's own copies of the ``repro.configs`` modules, one for every arch
of the reference, covering the dense, audio, moe, vlm, rwkv6 and hybrid
families, and of the registry's helpers: ``--arch <id>`` resolution for
launchers, and the dry-run cell matrix with its documented skips
(long_500k only runs for sub-quadratic-decode archs).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Iterator, List, Tuple

from repro_torch.models.common import ModelConfig

ARCH_MODULES = {
    "starcoder2-15b": "starcoder2_15b",
    "yi-6b": "yi_6b",
    "starcoder2-3b": "starcoder2_3b",
    "deepseek-67b": "deepseek_67b",
    "rwkv6-3b": "rwkv6_3b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "zamba2-1.2b": "zamba2_1p2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "musicgen-medium": "musicgen_medium",
    # the paper's own evaluation model (not part of the assigned 10)
    "gpt2-124m": "gpt2_124m",
}

ASSIGNED = [a for a in ARCH_MODULES if a != "gpt2-124m"]

# archs whose decode state is sub-quadratic (run long_500k)
SUBQUADRATIC = {"rwkv6-3b", "zamba2-1.2b"}


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def _module(arch: str):
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")


def get_config(arch: str, **overrides) -> ModelConfig:
    return _module(arch).config(**overrides)


def smoke_config(arch: str, **overrides) -> ModelConfig:
    return _module(arch).smoke_config(**overrides)


def list_archs() -> List[str]:
    return list(ARCH_MODULES)


def shape_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs, and why not if skipped."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, ("pure full-attention arch: 500k-token decode needs "
                       "sub-quadratic attention (skip per assignment; "
                       "DESIGN.md §4)")
    return True, ""


def cells(include_skipped: bool = False) -> Iterator[Tuple[str, Shape, bool, str]]:
    """All (arch x shape) dry-run cells with skip annotations."""
    for arch in ASSIGNED:
        for shape in SHAPES.values():
            ok, why = shape_applicable(arch, shape.name)
            if ok or include_skipped:
                yield arch, shape, ok, why
