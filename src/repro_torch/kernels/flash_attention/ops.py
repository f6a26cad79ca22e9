"""Flash-attention forward: wrapper, launch counter and device dispatch."""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import flash_attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
             ctypes.c_float, _I, _P]


_LIB = None          # the loaded library, its signature set once


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_fwd")
        lib.flash_fwd.argtypes = _ARGTYPES
        lib.flash_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    _build.dtype_code(q)
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"{KV} K/V heads do not divide {H} query heads")
    if hd not in _build.HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_build.HEAD_DIMS}")
    if min(B, Sq, k.shape[1]) < 1:
        raise ValueError("empty batch or sequence")
    if q.dtype == torch.bfloat16:   # the tensor-core body loads 16 bytes
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"bfloat16 {name} must be 16-byte aligned "
                                 f"with strides that are multiples of 8")


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """Attention forward over q (B, Sq, H, hd) and k, v (B, Sk, KV, hd).

    Returns (o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) float32). The
    causal mask is top-left aligned. A CPU tensor goes to the plain
    version; a CUDA tensor to the kernel, which reads q, k and v through
    their strides (the head dim must be contiguous)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else float(scale)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _build.dtype_code(q), B, H, KV, Sq, Sk, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], scale, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_cuda_status(err, "flash_fwd")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
