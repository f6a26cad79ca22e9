"""PyTorch/CUDA port of the model substrate (``repro`` stays the reference).

The port serves and trains the reference's model families on one NVIDIA
H100 through hand-written CUDA kernels (``repro_torch.kernels``). It
imports ``torch`` and numpy only: never ``jax`` and nothing of
``repro``. Every entry point takes a
``device``; the default is ``"cuda"``, and a machine without a card raises
unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``cuda`` and ``cpu`` run; ``meta`` only traces shapes (the launch
    dry-run, ``repro_torch.launch.dryrun``). Asking for ``cuda`` without a
    card raises instead of running on the CPU: the CPU is used only when
    the caller names it."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu' "
                         f"(or 'meta' to trace shapes)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
