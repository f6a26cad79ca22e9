"""Plain versions of the port's kernels against the Pallas kernels
(interpret mode) and their JAX oracles, plus the wrappers' dispatch.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerances are those of tests/test_kernels.py: f32 2e-3, bf16 5e-2; the
plain backward is held tighter in f32 (1e-5 relative), since it and the
Pallas backward do the same float32 arithmetic on the same inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import kernel as DK  # noqa: E402
from repro.kernels.decode_attention import ref as DR  # noqa: E402
from repro.kernels.flash_attention import kernel as FK  # noqa: E402
from repro.kernels.flash_attention import ref as FR  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as DO  # noqa: E402
from repro_torch.kernels.decode_attention import ref as TDR  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.flash_attention import ref as TFR  # noqa: E402

TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}

FLASH_SHAPES = [
    # (B, H, KV, Sq, Sk, hd, causal), as tests/test_kernels.py
    (1, 2, 2, 32, 32, 16, True),
    (2, 4, 2, 33, 33, 16, True),    # GQA + ragged
    (1, 4, 1, 48, 48, 32, True),    # MQA
    (1, 2, 2, 16, 64, 16, False),   # cross-shaped, non-causal
    (2, 2, 2, 64, 64, 8, True),
    # the model head dims, with Sq and Sk on both sides of the CUDA body's
    # 128-row query blocks and 128- (hd 64) or 64-key (hd 128) K/V tiles
    (1, 2, 1, 129, 127, 64, True),      # causal Sq > Sk
    (1, 2, 2, 127, 257, 128, True),     # causal Sq < Sk
    (1, 2, 1, 257, 257, 128, True),
    (1, 2, 1, 255, 129, 128, False),    # non-causal Sq > Sk
    (1, 2, 2, 129, 255, 64, False),     # non-causal Sq < Sk
    # kimi-k2's head dim 112 (the bf16 body's 128-column tiles, zero-filled
    # past 112): causal GQA across the 64-key tile, and ragged non-causal
    # Sq < Sk. kimi-k2's own 8 query heads a K/V head are held at hd 112
    # in test_torch_kimi.py and in DECODE_SHAPES: the float32 train check
    # below against float64 reads 1.9 of its limit in dK at G = 8 and 40
    # tokens (1.4 at hd 64): float32 rounding of the 8 heads' sum
    (1, 4, 2, 65, 65, 112, True),
    (2, 2, 2, 33, 70, 112, False),
]

DECODE_SHAPES = [
    # (B, H, KV, S, hd, cache_len), as tests/test_kernels.py
    (2, 4, 2, 64, 16, 64),
    (1, 4, 4, 96, 32, 50),
    (3, 8, 2, 128, 16, 128),
    (1, 2, 1, 40, 8, 7),
    # kimi-k2's head dim 112 and 8 query heads a K/V head
    (2, 8, 1, 96, 112, 77),
]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch CPU tensor of ``dtype``
    (both frameworks round float32 to bfloat16 to nearest even)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_plain_matches_pallas_and_ref(shape, dtype):
    B, H, KV, Sq, Sk, hd, causal = shape
    rng = np.random.RandomState(0)
    qn = rng.randn(B, Sq, H, hd).astype(np.float32)
    kn = rng.randn(B, Sk, KV, hd).astype(np.float32)
    vn = rng.randn(B, Sk, KV, hd).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (qn, kn, vn))
    # the JAX package's layout is (B, heads, S, hd)
    qj, kj, vj = (a.transpose(0, 2, 1, 3) for a in (qj, kj, vj))
    o_t, lse_t = TFR.flash_attention_ref(qt, kt, vt, causal=causal)
    assert o_t.dtype == qt.dtype and lse_t.dtype == torch.float32
    o_pl, lse_pl = FK.flash_fwd(qj, kj, vj, causal=causal, bq=16, bk=16)
    o_ref = FR.attention_ref(qj, kj, vj, causal=causal)
    o_t = _np(o_t).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(o_t, _np(o_pl), **TOL[dtype])
    np.testing.assert_allclose(o_t, _np(o_ref), **TOL[dtype])
    np.testing.assert_allclose(_np(lse_t), _np(lse_pl), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(lse_t),
                               _np(FR.lse_ref(qj, kj, causal=causal)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_plain_matches_pallas_and_ref(shape, dtype):
    B, H, KV, S, hd, clen = shape
    rng = np.random.RandomState(1)
    qn = rng.randn(B, H, hd).astype(np.float32)
    kn = rng.randn(B, S, KV, hd).astype(np.float32)
    vn = rng.randn(B, S, KV, hd).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (qn, kn, vn))
    kj, vj = kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3)
    o_t = _np(TDR.decode_attention_ref(qt, kt, vt, clen))
    o_pl = DK.decode_attention(qj, kj, vj, clen, bk=32)
    o_ref = DR.decode_attention_ref(qj, kj, vj, clen)
    np.testing.assert_allclose(o_t, _np(o_pl), **TOL[dtype])
    np.testing.assert_allclose(o_t, _np(o_ref), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens", [[1, 64, 33], [64, 7, 200], [5, 5, 5]])
def test_decode_plain_per_row_lengths_match_model_decode(lens, dtype):
    """(B,) lengths, one past the end of the cache, against the JAX
    package's plain decode (models/attention.py decode_attention), which
    admits all S rows for such a length."""
    B, H, KV, S, hd = 3, 8, 2, 64, 16
    rng = np.random.RandomState(2)
    qn = rng.randn(B, H, hd).astype(np.float32)
    kn = rng.randn(B, S, KV, hd).astype(np.float32)
    vn = rng.randn(B, S, KV, hd).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (qn, kn, vn))
    ln = np.asarray(lens, np.int32)
    o_t = TDR.decode_attention_ref(qt, kt, vt, torch.from_numpy(ln))
    o_j = JA.decode_attention(qj, kj, vj, jnp.asarray(ln))
    np.testing.assert_allclose(_np(o_t), _np(o_j), **TOL[dtype])


def test_decode_plain_empty_row_is_zero():
    """A length of 0 attends over nothing: the row is 0, as in the kernel."""
    q = torch.randn(2, 4, 16)
    kc, vc = torch.randn(2, 8, 2, 16), torch.randn(2, 8, 2, 16)
    o = TDR.decode_attention_ref(q, kc, vc, torch.tensor([0, 8]))
    assert torch.all(o[0] == 0)
    full = TDR.decode_attention_ref(q[1:], kc[1:], vc[1:], 8)
    torch.testing.assert_close(o[1:], full, rtol=0, atol=0)


def test_cpu_tensors_go_to_the_plain_versions():
    """The wrappers send a CPU tensor to the plain version: its counter
    moves, the kernel's does not, and the results are the plain ones."""
    q, k, v = torch.randn(1, 5, 4, 16), torch.randn(1, 5, 2, 16), \
        torch.randn(1, 5, 2, 16)
    f0, fr0 = FO.flash_attention.launches, TFR.flash_attention_ref.launches
    o, lse = FO.flash_attention(q, k, v, causal=True)
    assert (FO.flash_attention.launches, TFR.flash_attention_ref.launches) \
        == (f0, fr0 + 1)
    o_ref, lse_ref = TFR.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=0)
    d0, dr0 = DO.decode_attention.launches, TDR.decode_attention_ref.launches
    out = DO.decode_attention(q[:, 0], k, v, torch.tensor([3]))
    assert (DO.decode_attention.launches, TDR.decode_attention_ref.launches) \
        == (d0, dr0 + 1)
    assert out.shape == (1, 4, 16)


class _Elsewhere:
    """Stands for a tensor on a device that is neither the CPU, a card nor
    meta (the wrappers read ``.device`` before anything else)."""
    device = torch.device("xpu")
    shape = (1, 4, 2, 16)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a card (nor meta, which traces
    shapes) is refused, not computed."""
    q = k = _Elsewhere()
    with pytest.raises(ValueError, match="cuda or cpu"):
        FO.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="cuda or cpu"):
        DO.decode_attention(q, k, k, 3)


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc and no built library, building raises: no fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["decode"])


def test_build_target_changes_with_a_header(monkeypatch, tmp_path):
    """The library's name hashes the headers beside its source too, so an
    edited header builds anew instead of loading a stale library."""
    csrc = tmp_path / "flash_attention" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "flash_fwd.cu").write_text('#include "hopper.cuh"\n')
    (csrc / "hopper.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    first = _build._target("flash_fwd")
    assert first == _build._target("flash_fwd")
    (csrc / "hopper.cuh").write_text("// v2\n")
    edited = _build._target("flash_fwd")
    assert edited != first and edited.parent == first.parent
    assert edited.name.startswith("flash_fwd-")
    (csrc / "other.cuh").write_text("// new\n")
    assert _build._target("flash_fwd") not in (first, edited)



def test_build_target_changes_with_the_shared_header(monkeypatch, tmp_path):
    """``csrc/hopper.cuh`` sits beside ``_build.py``, shared by B1, B2, B3,
    B4 and B5: an edit to it changes the library path of every kernel whose
    source includes it, and of no other. Run on a copy of the sources."""
    import shutil
    src = _build.KERNELS_DIR
    for rel in [*_build.SOURCES.values(), "csrc/hopper.cuh"]:
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src / rel, tmp_path / rel)
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path)
    before = {n: _build._target(n) for n in _build.SOURCES}
    header = tmp_path / "csrc" / "hopper.cuh"
    header.write_text(header.read_text() + "// edited\n")
    changed = {n for n in _build.SOURCES if _build._target(n) != before[n]}
    assert changed == {"flash_fwd", "flash_bwd", "decode", "ssd_scan",
                       "rwkv6_scan"}
    for n in changed:
        assert _build._included(tmp_path / _build.SOURCES[n]) == [header]


def test_build_log_is_read_back_beside_a_cached_library(monkeypatch,
                                                         tmp_path):
    """nvcc's output stays beside the library, so a later process that
    loads the cached library still has ptxas's report of it."""
    csrc = tmp_path / "src" / "flash_attention" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "flash_fwd.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path / "src")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "LOGS", {})
    assert _build.log("flash_fwd") == ""
    (tmp_path / "build").mkdir()
    _build._target("flash_fwd").with_suffix(".log").write_text("ptxas v1")
    assert _build.log("flash_fwd") == "ptxas v1"
    (csrc / "flash_fwd.cu").write_text("// v2\n")
    assert _build.log("flash_fwd") == ""
    _build.LOGS["flash_fwd"] = "this process"
    assert _build.log("flash_fwd") == "this process"

def test_kernel_input_checks():
    """The shape, dtype and layout checks the wrappers run before a
    launch (on a card) refuse what the kernels do not take."""
    q, k = torch.randn(1, 4, 8, 16), torch.randn(1, 4, 2, 16)
    FO._check(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        FO._check(q[..., :8], k[..., :8], k[..., :8])
    with pytest.raises(ValueError, match="do not divide"):
        FO._check(q, torch.randn(1, 4, 3, 16), torch.randn(1, 4, 3, 16))
    with pytest.raises(ValueError, match="contiguous"):
        FO._check(q, k.transpose(-1, -2).contiguous().transpose(-1, -2), k)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        FO._check(q.half(), k.half(), k.half())
    FO._check(q.bfloat16(), k.bfloat16(), k.bfloat16())
    odd = torch.randn(1, 4, 2, 17).bfloat16()[..., 1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        FO._check(q.bfloat16(), odd, odd)
    DO._check(q[:, 0], k, k)
    with pytest.raises(ValueError, match="do not match"):
        DO._check(q[:, 0], k, k[:, :3])
    odd = torch.randn(1, 4, 2, 18)[..., 2:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        DO._check(q[:, 0], odd, odd)
    assert DO._lens_on_device(7, 3, "cpu").tolist() == [7, 7, 7]
    with pytest.raises(ValueError, match="scalar or"):
        DO._lens_on_device([1, 2], 3, "cpu")
    with pytest.raises(TypeError, match="integers"):
        DO._lens_on_device(torch.tensor([1.0, 2.0, 3.0]), 3, "cpu")


def test_kernel_input_checks_refuse_mixed_devices():
    """A K/V tensor on another device than q is refused before a launch."""
    q, k = torch.randn(1, 4, 8, 16), torch.randn(1, 4, 2, 16)
    with pytest.raises(ValueError, match="is on"):
        FO._check(q, k.to("meta"), k)
    with pytest.raises(ValueError, match="is on"):
        DO._check(q[:, 0], k, k.to("meta"))


@pytest.mark.parametrize("ln, at, attend", [
    (torch.tensor(5, dtype=torch.int32), 5, [6, 6, 6]),
    (torch.tensor(9, dtype=torch.int32), 7, [10, 10, 10]),
    (torch.tensor([0, 7, 30], dtype=torch.int32), [0, 7, 7], [1, 8, 31]),
])
def test_decode_rows_clamp_writes_and_hand_lengths_over(ln, at, attend):
    """A decode step's write rows are clamped to the cache (S=8) and its
    (B,) int32 lengths go to the kernel wrapper as they are."""
    from repro_torch.models.attention import decode_rows
    got_at, got_attend = decode_rows(ln, 3, 8)
    assert got_at.dim() == ln.dim() and got_at.tolist() == at
    assert got_attend.dtype == torch.int32 and got_attend.is_contiguous()
    assert got_attend.tolist() == attend
    assert DO._lens_on_device(got_attend, 3, "cpu") is got_attend


# ---------------------------------------------------------------------------
# flash-attention backward (B2a, B2b) and the autograd Function
# ---------------------------------------------------------------------------

# FLASH_SHAPES holds the two shapes of tests/test_kernels.py:61-80 as well
BWD_SHAPES = FLASH_SHAPES
BWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": TOL["bfloat16"]}


def _bwd_inputs(shape, dtype, seed):
    """q, k, v, do as (jax (B, heads, S, hd), torch (B, S, heads, hd))
    pairs with the same values."""
    B, H, KV, Sq, Sk, hd, causal = shape
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(B, S, n, hd).astype(np.float32)
              for S, n in ((Sq, H), (Sk, KV), (Sk, KV), (Sq, H))]
    pairs = [_pair(a, dtype) for a in arrays]
    return [(j.transpose(0, 2, 1, 3), t) for j, t in pairs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_bwd_plain_matches_pallas_and_autodiff(shape, dtype):
    """flash_attention_bwd_ref against the Pallas backward (interpret mode)
    on the same residuals, and against jax.grad of attention_ref: float32
    to 1e-5, bfloat16 to TOL."""
    causal = shape[-1]
    (qj, qt), (kj, kt), (vj, vt), (doj, dot) = _bwd_inputs(shape, dtype, 3)
    o_t, lse_t = TFR.flash_attention_ref(qt, kt, vt, causal=causal)
    dq, dk, dv = TFR.flash_attention_bwd_ref(qt, kt, vt, o_t, lse_t, dot,
                                             causal=causal)
    assert (dq.dtype, dk.dtype, dv.dtype) == (qt.dtype, kt.dtype, vt.dtype)
    got = [_np(g).transpose(0, 2, 1, 3) for g in (dq, dk, dv)]
    # the Pallas backward on the same o and lse
    oj = jnp.asarray(_np(o_t).transpose(0, 2, 1, 3)).astype(qj.dtype)
    lj = jnp.asarray(_np(lse_t))
    pallas = FK.flash_bwd(qj, kj, vj, oj, lj, doj, causal=causal, bq=16,
                          bk=16)
    _, vjp = jax.vjp(lambda q, k, v: FR.attention_ref(q, k, v, causal=causal),
                     qj, kj, vj)
    autodiff = vjp(doj)
    for name, g, p, a in zip("qkv", got, pallas, autodiff):
        np.testing.assert_allclose(g, _np(p), **BWD_TOL[dtype],
                                   err_msg=f"d{name} vs Pallas")
        np.testing.assert_allclose(g, _np(a), **BWD_TOL[dtype],
                                   err_msg=f"d{name} vs jax.grad")


def _direct_attention(q, k, v, causal):
    """Full-matrix attention written out, differentiated by autograd."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    kr, vr = (t.repeat_interleave(H // KV, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q * hd ** -0.5, kr)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        s = s.masked_fill(torch.arange(Sk)[None, :] > torch.arange(Sq)[:, None],
                          float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vr)


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_attention_train_matches_autograd_on_cpu(shape):
    """The autograd Function on float32 CPU tensors (plain forward and
    backward) against torch autograd of a direct full-matrix attention in
    float64 on the same values: they agree to float32 rounding (1e-5)."""
    causal = shape[-1]
    q, k, v, do = (t.requires_grad_() for _, t in
                   _bwd_inputs(shape, "float32", 5))
    do = do.detach()
    o = FO.flash_attention_train(q, k, v, causal=causal)
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    want = _direct_attention(q64, k64, v64, causal)
    torch.testing.assert_close(o.double(), want, rtol=1e-5, atol=1e-6)
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = torch.autograd.grad(want, (q64, k64, v64), do.double())
    for name, g, r in zip("qkv", got, ref):
        torch.testing.assert_close(g.double(), r, rtol=1e-5, atol=1e-6,
                                   msg=f"d{name}")


def test_flash_attention_train_runs_the_plain_versions_on_cpu():
    """On the CPU, one forward and one backward run the plain versions,
    once each; the kernel launchers do not move. Under no_grad only the
    forward runs."""
    q = torch.randn(1, 5, 4, 16, requires_grad=True)
    k = torch.randn(1, 5, 2, 16, requires_grad=True)
    v = torch.randn(1, 5, 2, 16, requires_grad=True)
    counters = (TFR.flash_attention_ref, TFR.flash_attention_bwd_ref,
                FO.flash_attention, FO.flash_bwd_dq, FO.flash_bwd_dkv)
    before = [f.launches for f in counters]
    o = FO.flash_attention_train(q, k, v)
    o.sum().backward()
    assert [f.launches - b for f, b in zip(counters, before)] == \
        [1, 1, 0, 0, 0]
    with torch.no_grad():
        FO.flash_attention_train(q, k, v)
    assert [f.launches - b for f, b in zip(counters, before)] == \
        [2, 1, 0, 0, 0]
    o_ref, lse = TFR.flash_attention_ref(q, k, v)
    dq, dk, dv = FO.flash_attention_bwd(q, k, v, o_ref, lse,
                                        torch.ones_like(o_ref))
    for g, t in zip((dq, dk, dv), (q, k, v)):
        torch.testing.assert_close(g, t.grad, rtol=0, atol=0)


def test_flash_bwd_input_checks():
    """What the backward kernels do not take is refused before a launch;
    a dO they cannot read through its strides is copied first."""
    q, k = torch.randn(1, 4, 8, 16), torch.randn(1, 4, 2, 16)
    lse = torch.randn(1, 8, 4)
    FO._check_bwd(q, k, k, q, lse, q)
    with pytest.raises(ValueError, match="does not match q"):
        FO._check_bwd(q, k, k, q[:, :3], lse, q)
    with pytest.raises(ValueError, match="does not match q"):
        FO._check_bwd(q, k, k, q, lse, q.double())
    with pytest.raises(ValueError, match="lse"):
        FO._check_bwd(q, k, k, q, lse.transpose(1, 2).contiguous()
                      .transpose(1, 2)[..., :4], q)
    with pytest.raises(ValueError, match="lse"):
        FO._check_bwd(q, k, k, q, lse.double(), q)
    with pytest.raises(ValueError, match="head dim"):
        FO._check_bwd(q[..., :8], k[..., :8], k[..., :8], q[..., :8], lse,
                      q[..., :8])
    # an expanded gradient (stride 0) and a misaligned bfloat16 one are
    # copied; a readable one is handed over as it is
    expanded = torch.ones(()).expand(1, 4, 8, 16)
    assert FO._kernel_layout(expanded).stride() == (512, 128, 16, 1)
    odd = torch.randn(1, 4, 8, 17).bfloat16()[..., 1:]
    fixed = FO._kernel_layout(odd)
    assert fixed.is_contiguous() and torch.equal(fixed, odd)
    bf = q.bfloat16()
    assert FO._kernel_layout(bf) is bf


def test_flash_bwd_wrapper_refuses_other_devices():
    q = _Elsewhere()
    with pytest.raises(ValueError, match="cuda or cpu"):
        FO.flash_attention_bwd(q, q, q, q, torch.empty(1, 2, 4), q)
