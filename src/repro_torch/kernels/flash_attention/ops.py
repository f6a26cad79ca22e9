"""Flash attention: the forward and backward wrappers, their launch
counters and device dispatch, and the autograd Function that ties them
together for training."""

from __future__ import annotations

import ctypes

import torch

from ... import spans
from .. import _build
from .ref import flash_attention_bwd_ref, flash_attention_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
             ctypes.c_float, _I, _P]


_BWD_ARGTYPES = {
    "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _P, ctypes.c_float, _I, _P],
    "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _P, ctypes.c_float, _I, _P],
}
_Strides = ctypes.c_longlong * 21


_LIB = None          # the loaded libraries, their signatures set once
_BWD_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_fwd")
        lib.flash_fwd.argtypes = _ARGTYPES
        lib.flash_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _bwd_lib():
    global _BWD_LIB
    if _BWD_LIB is None:
        lib = _build.load("flash_bwd")
        for name, argtypes in _BWD_ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _BWD_LIB = lib
    return _BWD_LIB


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
    if q.dtype == torch.bfloat16:   # TMA's condition for the bf16 body
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
                raise ValueError(f"bfloat16 {name} must be 16-byte aligned "
                                 f"with strides that are multiples of 8")


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """Attention forward over q (B, Sq, H, hd) and k, v (B, Sk, KV, hd).

    Returns (o (B, Sq, H, hd) in q's dtype, lse (B, H, Sq) float32). The
    causal mask is top-left aligned. A CPU tensor goes to the plain
    version; a CUDA tensor to the kernel, which reads q, k and v through
    their strides (the head dim must be contiguous). A meta tensor takes
    the kernel's checks and allocations and stops before the launch: the
    outputs' shapes, nothing computed, no launch counted."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else float(scale)
    o = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return o, lse
    lib = _lib()
    with spans.span("kernel.B1"), torch.cuda.device(q.device):
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


def _kernel_layout(t):
    """``t`` as the bfloat16/float32 kernels read it: the head dim
    contiguous and, in bfloat16, 16-byte aligned with strides that are
    multiples of 8. Anything else (an expanded gradient, say) is copied
    into a contiguous tensor."""
    ok = t.stride(-1) == 1 and all(st > 0 for st in t.stride()[:3])
    if ok and t.dtype == torch.bfloat16:
        ok = t.data_ptr() % 16 == 0 \
            and all(st % 8 == 0 for st in t.stride()[:3])
    return t if ok else t.contiguous()


def _check_bwd(q, k, v, o, lse, do) -> None:
    _check(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}")
    B, Sq, H, _ = q.shape
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous float32 (B, H, Sq) = "
                         f"{(B, H, Sq)} tensor on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def _strides(q, k, v, do, dq, dk, dv):
    """The (batch, sequence, head) strides of the seven tensors, as the
    backward kernels' C entry points take them."""
    return _Strides(*(st for t in (q, k, v, do, dq, dk, dv)
                      for st in t.stride()[:3]))


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, scale: float):
    """B2a on checked CUDA (or meta) tensors: dQ (B, Sq, H, hd) in q's
    dtype."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.device.type == "meta":
        return dq
    with torch.cuda.device(q.device):
        err = _bwd_lib().flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _build.dtype_code(q), B, H, KV, Sq, Sk, hd,
            _strides(q, k, v, do, dq, k, v), scale, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_cuda_status(err, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, scale: float):
    """B2b on checked CUDA (or meta) tensors: (dK, dV), each (B, Sk, KV,
    hd) in k's dtype and summed over the query heads of its K/V head."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.device.type == "meta":
        return dk, dv
    with torch.cuda.device(q.device):
        err = _bwd_lib().flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _build.dtype_code(q), B, H, KV, Sq, Sk, hd,
            _strides(q, k, v, do, q, dk, dv), scale, int(causal),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_cuda_status(err, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        scale=None):
    """Attention backward from the forward's residuals: (dq, dk, dv).

    q, o, do (B, Sq, H, hd); k, v (B, Sk, KV, hd); lse (B, H, Sq) float32,
    as :func:`flash_attention` returns it. A CPU tensor goes to the plain
    version; a CUDA tensor to the two kernels, dQ (B2a) then dK/dV (B2b),
    which read every tensor through its strides. ``do`` may come with any
    strides (autograd hands over what it has); one the kernels cannot read
    is copied first. delta = rowsum(o * do) is formed here in float32, as
    the reference forms it outside its Pallas calls. A meta tensor takes
    the kernels' checks and allocations (delta, dq, dk, dv and any copy of
    do) and launches nothing."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    with spans.span("kernel.B2", q.device.type == "cuda"):
        do = _kernel_layout(do)
        _check_bwd(q, k, v, o, lse, do)
        scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
        # do is promoted inside the product: the float32 products of
        # o.float() * do.float(), bit for bit, without a float32 copy of do
        delta = (o.float() * do).sum(-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
        return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is ``fwd`` and whose backward is ``bwd``,
    from the residuals (q, k, v, o, lse): no probability matrix is kept
    between the two. :func:`flash_attention_train` passes the wrappers, so
    the device picks kernels or plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, fwd, bwd):
        o, lse = fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale, ctx.bwd = causal, scale, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do, causal=ctx.causal,
                             scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_train(q, k, v, causal: bool = True, scale=None):
    """Differentiable attention: o (B, Sq, H, hd) in q's dtype, with the
    forward kernel (B1) one way and the backward kernels (B2a, B2b) the
    other on a CUDA tensor, the plain versions on a CPU tensor. Where no
    gradient is wanted (serving's prefill) it is the forward alone."""
    if not (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention(q, k, v, causal=causal, scale=scale)[0]
    return FlashAttention.apply(q, k, v, causal, scale, flash_attention,
                                flash_attention_bwd)
