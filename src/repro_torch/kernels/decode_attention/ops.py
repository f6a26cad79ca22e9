"""Decode attention: wrapper, launch counter and device dispatch."""

from __future__ import annotations

import ctypes
import functools

import torch

from ... import spans
from .. import _build
from .ref import decode_attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float, _P]


_LIB = None          # the loaded library, its signatures set once


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("decode")
        lib.decode_attention.argtypes = _ARGTYPES
        lib.decode_attention.restype = ctypes.c_int
        lib.decode_workspace_floats.argtypes = [_I] * 5
        lib.decode_workspace_floats.restype = _L
        _LIB = lib
    return _LIB


# decode.cu's BS (cache rows a chunk) and HEADS (query heads a block)
CHUNK_ROWS = 64
BLOCK_HEADS = 8


@functools.lru_cache(maxsize=None)
def _workspace_floats(B: int, H: int, KV: int, S: int, hd: int) -> int:
    """Floats of the partial outputs the kernel lays out for a call; their
    max and sum take this many / hd * 2. Asked once a shape, so that a
    decode step pays no ctypes call for it."""
    return _lib().decode_workspace_floats(B, H, KV, S, hd)


def workspace_floats(B: int, H: int, KV: int, S: int, hd: int) -> int:
    """The library's ``decode_workspace_floats`` without the library (the
    meta branch sizes the workspace with it): each (b, KV head) gets its
    query heads padded to BLOCK_HEADS, times its chunks of CHUNK_ROWS, of
    hd floats."""
    G = H // KV
    padded = -(-G // BLOCK_HEADS) * BLOCK_HEADS
    return B * KV * padded * -(-S // CHUNK_ROWS) * hd


def _check(q, k_cache, v_cache) -> None:
    for name, t, nd in (("q", q, 3), ("k_cache", k_cache, 4),
                        ("v_cache", v_cache, 4)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != nd:
            raise ValueError(f"{name} must be {nd}-D, got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
    _build.dtype_code(q)
    B, H, hd = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != hd):
        raise ValueError(f"caches {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    KV = k_cache.shape[2]
    if H % KV:
        raise ValueError(f"{KV} K/V heads do not divide {H} query heads")
    if hd not in _build.HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_build.HEAD_DIMS}")
    if min(B, k_cache.shape[1]) < 1:
        raise ValueError("empty batch or cache")
    per16 = 16 // q.element_size()      # the kernel loads 16 bytes at a time
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16 or any(st % per16 for st in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides "
                             f"that are multiples of 16 bytes")


def _lens_on_device(lens, B: int, device) -> torch.Tensor:
    """(B,) contiguous int32 lengths on ``device`` from a scalar or (B,)."""
    if (isinstance(lens, torch.Tensor) and lens.dtype == torch.int32
            and lens.shape == (B,) and lens.is_contiguous()
            and lens.device == torch.device(device)):
        return lens      # as the decode step hands them over
    lens = torch.as_tensor(lens, device=device)
    if lens.dim() > 1 or (lens.dim() == 1 and lens.shape[0] != B):
        raise ValueError(f"lens must be a scalar or ({B},), "
                         f"got {tuple(lens.shape)}")
    if lens.dtype.is_floating_point or lens.dtype == torch.bool:
        raise TypeError(f"lens must be integers, not {lens.dtype}")
    return lens.to(torch.int32).expand(B).contiguous()


def decode_attention(q, k_cache, v_cache, lens, scale=None):
    """One query token per (b, h) against a (B, S, KV, hd) cache.

    q: (B, H, hd); ``lens``: a scalar or (B,) lengths, and row b attends
    over its first min(len_b, S) cache rows. Returns (B, H, hd) in q's
    dtype. A CPU tensor goes to the plain version; a CUDA tensor to the
    kernel, which reads the caches through their strides. A meta tensor
    takes the kernel's checks and allocations (o and the workspace) and
    stops before the launch: nothing computed, no launch counted."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lens, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    _check(q, k_cache, v_cache)
    B, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = hd ** -0.5 if scale is None else float(scale)
    lens = _lens_on_device(lens, B, q.device)
    meta = q.device.type == "meta"
    lib = None if meta else _lib()
    o = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    # the partial outputs and their max and sum, laid out by the kernel
    n = (workspace_floats if meta else _workspace_floats)(B, H, KV, S, hd)
    part_o = torch.empty(n, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(n // hd * 2, dtype=torch.float32, device=q.device)
    if meta:
        return o
    with spans.span("kernel.B3"), torch.cuda.device(q.device):
        err = lib.decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lens.data_ptr(), o.data_ptr(), part_o.data_ptr(),
            part_ml.data_ptr(), _build.dtype_code(q),
            B, H, KV, S, hd, *q.stride()[:2], *k_cache.stride()[:3],
            *v_cache.stride()[:3], *o.stride()[:2], scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_cuda_status(err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
