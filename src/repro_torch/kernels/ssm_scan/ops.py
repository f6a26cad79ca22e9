"""Mamba2 SSD scan: wrapper, launch counter and device dispatch, and the
autograd Function whose backward differentiates the plain scan."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import ssd_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P]
_Strides = ctypes.c_longlong * 14

# the (head dim P, state size N) pairs the kernel is compiled for (csrc):
# zamba2-1.2b's and its smoke width's
SHAPES = ((64, 64), (32, 16))

_LIB = None          # the loaded library, its signature set once


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("ssd_scan")
        lib.ssd_scan.argtypes = _ARGTYPES
        lib.ssd_scan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(xh, dt, A, Bm, Cm) -> None:
    for name, t, nd in (("xh", xh, 4), ("dt", dt, 3), ("A", A, 1),
                        ("Bm", Bm, 3), ("Cm", Cm, 3)):
        if t.device != xh.device:
            raise ValueError(f"{name} is on {t.device}, xh on {xh.device}")
        if t.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D, got {tuple(t.shape)}")
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if t.dtype != xh.dtype:
            raise TypeError(f"{name} is {t.dtype}, xh is {xh.dtype}")
    _build.dtype_code(xh)
    if A.dtype != torch.float32:
        raise TypeError(f"A must be float32, not {A.dtype}")
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    if dt.shape != (B, T, H) or A.shape != (H,) \
            or Bm.shape != (B, T, N) or Cm.shape != (B, T, N):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)} and Cm {tuple(Cm.shape)} do "
                         f"not match xh {tuple(xh.shape)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"(head dim, state size) ({P}, {N}): the kernel "
                         f"takes {SHAPES} only")
    if min(B, T, H) < 1:
        raise ValueError("empty batch, sequence or heads")
    if xh.dtype == torch.bfloat16:
        for name, t in (("xh", xh), ("Bm", Bm), ("Cm", Cm)):
            if not _tma_readable(t):
                raise ValueError(
                    f"bfloat16 {name} (strides {t.stride()}) must be "
                    f"16-byte aligned, contiguous in its last dimension, "
                    f"with its other strides multiples of 8 elements: the "
                    f"bf16 body reads it by TMA")


def _tma_readable(t) -> bool:
    """Whether the bf16 body's tensor maps can read ``t``: a 16-byte
    aligned base, unit stride in the last dimension and positive strides
    of multiples of 8 elements (16 bytes) in the others, where the extent
    is above 1 (the kernel gives an extent of 1 a packed stride)."""
    *outer, last = zip(t.shape, t.stride())
    return t.data_ptr() % 16 == 0 and last[1] == 1 and all(
        st > 0 and st % 8 == 0 for n, st in outer if n > 1)


def _launch(xh, dt, A, Bm, Cm, return_state: bool = True):
    """B4 on checked CUDA tensors: (y (B, T, H, P) float32, the final state
    (B, H, P, N) float32, or None when ``return_state`` is False). On meta
    tensors, the same allocations and no launch."""
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    y = torch.empty((B, T, H, P), dtype=torch.float32, device=xh.device)
    state = (torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
             if return_state else None)
    if xh.device.type == "meta":
        return y, state
    strides = _Strides(*xh.stride(), *dt.stride(), *A.stride(), *Bm.stride(),
                       *Cm.stride())
    with torch.cuda.device(xh.device):
        err = _lib().ssd_scan(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(),
            state.data_ptr() if return_state else None,
            _build.dtype_code(xh), B, T, H, P, N, strides,
            torch.cuda.current_stream(xh.device).cuda_stream)
    _build.check_cuda_status(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, state


class SSDScan(torch.autograd.Function):
    """The scan with the kernel one way and, the other, autograd of the
    plain scan (checkpointed in chunks of 64 steps), recomputed from the
    inputs: the reference's custom VJP (kernels/ssm_scan/ops.py), which
    has no backward kernel either. Returns (y, final state)."""

    @staticmethod
    def forward(ctx, xh, dt, A, Bm, Cm):
        ctx.save_for_backward(xh, dt, A, Bm, Cm)
        ctx.set_materialize_grads(False)
        return _launch(xh, dt, A, Bm, Cm)

    @staticmethod
    def backward(ctx, g_y, g_state):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        want = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            outs = ssd_scan_ref(*inputs)
        pairs = [(o, g) for o, g in zip(outs, (g_y, g_state)) if g is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in inputs)


def ssd_scan(xh, dt, A, Bm, Cm, return_state: bool = False):
    """The Mamba2 SSD scan from a zero state (see
    :func:`~repro_torch.kernels.ssm_scan.ref.ssd_scan_ref`).

    xh: (B, T, H, P); dt: (B, T, H); Bm, Cm: (B, T, N), all float32 or all
    bfloat16; A: (H,) float32. Returns y (B, T, H, P) float32 and, with
    ``return_state``, also the final state (B, H, P, N) float32. A CPU
    tensor goes to the plain version; a CUDA tensor to the kernel (B4),
    which reads every input through its strides and takes (P, N) in
    :data:`SHAPES`: float32 inputs take its CUDA-core body, bfloat16 ones
    its wgmma body, which needs xh, Bm and Cm in a layout that TMA reads
    (:func:`_tma_readable`). Where autograd wants a gradient, the kernel
    runs under :class:`SSDScan`. A meta tensor takes the kernel path's
    checks and allocations and launches nothing (its backward, the plain
    scan's autograd, runs on meta too)."""
    if xh.device.type == "cpu":
        y, state = ssd_scan_ref(xh, dt, A, Bm, Cm)
    elif xh.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {xh.device}")
    else:
        _check(xh, dt, A, Bm, Cm)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (xh, dt, A, Bm, Cm)):
            y, state = SSDScan.apply(xh, dt, A, Bm, Cm)
        else:
            y, state = _launch(xh, dt, A, Bm, Cm, return_state)
    return (y, state) if return_state else y


ssd_scan.launches = 0
