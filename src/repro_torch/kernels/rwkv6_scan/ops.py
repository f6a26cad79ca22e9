"""RWKV6 scan: wrapper, launch counter and device dispatch, and the autograd
Function whose backward differentiates the plain scan."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rwkv6_scan_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
_Strides = ctypes.c_longlong * 18

HEAD_SIZE = 64   # the N the kernel is compiled for (csrc)

_LIB = None          # the loaded library, its signature set once


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rwkv6_scan")
        lib.rwkv6_scan.argtypes = _ARGTYPES
        lib.rwkv6_scan.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(r, k, v, w, u) -> None:
    for name, t, nd in (("r", r, 4), ("k", k, 4), ("v", v, 4), ("w", w, 4),
                        ("u", u, 2)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D, got {tuple(t.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != r.dtype:
            raise TypeError(f"{name} is {t.dtype}, r is {r.dtype}")
    _build.dtype_code(r)
    for name, t in (("w", w), ("u", u)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
    B, T, H, N = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape \
            or u.shape != (H, N):
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)} and u {tuple(u.shape)} do not "
                         f"match r {tuple(r.shape)}")
    if N != HEAD_SIZE:
        raise ValueError(f"head size {N}: the kernel takes {HEAD_SIZE} only")
    if min(B, T, H) < 1:
        raise ValueError("empty batch, sequence or heads")


def _launch(r, k, v, w, u):
    """B5 on checked CUDA tensors: (y (B, T, H, N) float32, the final state
    (B, H, N, N) float32). On meta tensors, the same allocations and no
    launch."""
    B, T, H, N = r.shape
    y = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if r.device.type == "meta":
        return y, state
    strides = _Strides(*r.stride(), *k.stride(), *v.stride(), *w.stride(),
                       *u.stride())
    with torch.cuda.device(r.device):
        err = _lib().rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), state.data_ptr(),
            _build.dtype_code(r), B, T, H, N, strides,
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check_cuda_status(err, "rwkv6_scan")
    rwkv6_scan.launches += 1
    return y, state


class RWKV6Scan(torch.autograd.Function):
    """The scan with the kernel one way and, the other, autograd of the
    plain scan (checkpointed in chunks of 64 steps), recomputed from the
    inputs: the reference's custom VJP (kernels/rwkv6_scan/ops.py), which
    has no backward kernel either. Returns (y, final state)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.set_materialize_grads(False)
        return _launch(r, k, v, w, u)

    @staticmethod
    def backward(ctx, g_y, g_state):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        want = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            outs = rwkv6_scan_ref(*inputs)
        pairs = [(o, g) for o, g in zip(outs, (g_y, g_state)) if g is not None]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in inputs)


def rwkv6_scan(r, k, v, w, u):
    """The RWKV6 scan from a zero state (see
    :func:`~repro_torch.kernels.rwkv6_scan.ref.rwkv6_scan_ref`).

    r, k, v: (B, T, H, N), all float32 or all bfloat16; w: (B, T, H, N)
    float32; u: (H, N) float32. Returns y (B, T, H, N) float32 and the final
    state (B, H, N, N) float32. A CPU tensor goes to the plain version; a
    CUDA tensor to the kernel (B5), which reads every input through its
    strides, takes any T and N = 64 only. Where autograd wants a gradient,
    the kernel runs under :class:`RWKV6Scan`. A meta tensor takes the
    kernel path's checks and allocations and launches nothing (its
    backward, the plain scan's autograd, runs on meta too)."""
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u)
    if r.device.type not in ("cuda", "meta"):
        raise ValueError(f"rwkv6_scan runs on cuda or cpu, not {r.device}")
    _check(r, k, v, w, u)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u)):
        return RWKV6Scan.apply(r, k, v, w, u)
    return _launch(r, k, v, w, u)


rwkv6_scan.launches = 0
