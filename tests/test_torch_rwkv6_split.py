"""The precision plan of B5's bf16 body (``rwkv6_scan/csrc/rwkv6_scan.cu``),
emulated on the CPU in PyTorch.

The body runs the chunked RWKV6 form over 64-step chunks cut into 16-step
sub-chunks. Every decay is a product of the w's between two steps (never a
ratio), and w is 1 past T. Its products run on bf16 tensor cores with
float32 sums, each float32 operand as ``TERMS`` bf16 terms (its value
rounded, then what that leaves truncated, ...: ``hopper.cuh``'s ``split``),
the count the source sets:

- P1  y  = (r o D) S0        both float32: term pairs qa + qb < TERMS
- P2  A  = Q^(j) K_j^T       both float32: the same pairs
- P3  y += A V               A's terms against the bf16 V
- P4  S <- D_l o S + K~^T V  K~'s terms against V

and A's diagonal 16-step blocks (with the bonus term on their diagonal) in
float32. The emulation repeats that arithmetic and is held, under
``chip_smoke.py``'s SSD_REL_L2 and SSD_TOL (the limits that hold the kernel
against the plain scan on the card), against the port's plain scan and
against the JAX package's scan: its Pallas kernel in interpret mode for y,
its plain scan for the final state. One bf16 term fails those limits, and
so does the body's form with the decays of the steps past T left at the
zeros that TMA fills in. The emulation lives here and not in the package:
nothing on the main path calls it.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_scan import kernel as JRK  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as RR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu"
HEADER = ROOT / "src/repro_torch/kernels/csrc/hopper.cuh"
TERMS = int(re.search(r"constexpr int TERMS = (\d+);",
                      SOURCE.read_text()).group(1))
CHUNK, SUB = 64, 16


def bf16_terms(x: torch.Tensor, k: int) -> list:
    """float32 ``x`` as ``k`` bf16 terms (as float32), as ``hopper.cuh``'s
    ``split`` cuts them: x rounded to nearest, then each remainder truncated
    (its low 16 bits dropped); every remainder is exact in float32."""
    out = [x.bfloat16().float()]
    for _ in range(k - 1):
        x = x - out[-1]
        out.append((x.view(torch.int32) & -65536).view(torch.float32))
    return out


def both_split(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int):
    """A product of two float32 operands: the products of their term pairs
    (qa, qb) with qa + qb < terms."""
    ta, tb = bf16_terms(a, terms), bf16_terms(b, terms)
    return sum(torch.einsum(eq, ta[qa], tb[qb])
               for qa in range(terms) for qb in range(terms - qa))


def one_split(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int):
    """A product of a float32 operand and a bf16 one: the products of the
    first one's terms."""
    return sum(torch.einsum(eq, ta, b) for ta in bf16_terms(a, terms))


def exclusive_prod(w: torch.Tensor, dim: int, reverse: bool = False):
    """prod of w before each index along ``dim`` (after it, ``reverse``),
    by running products."""
    if reverse:
        return exclusive_prod(w.flip(dim), dim).flip(dim)
    ones = torch.ones_like(w.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([ones, w.narrow(dim, 0, w.shape[dim] - 1)],
                                   dim=dim), dim=dim)


def emulate(r, k, v, w, u, terms: int, past_t_decays: float = 1.0):
    """The bf16 body's arithmetic: (y (B, T, H, N), final state (B, H, N,
    N)), float32. ``past_t_decays``: the w that the decays take at a
    chunk's steps past T (the body: 1; TMA's zero fill: 0)."""
    B, T, H, N = r.shape
    r, k, v, w, u = (t.float() for t in (r, k, v, w, u))
    S = torch.zeros(B, H, N, N)
    ys = []
    for t0 in range(0, T, CHUNK):
        n = min(CHUNK, T - t0)

        def tile(x, fill=0.0):       # the chunk's 64 rows, (B, 64, H, N)
            x = x[:, t0:t0 + n]
            return torch.cat([x, torch.full((B, CHUNK - n, H, N), fill)], 1)

        rc, kc, vc, w_raw = tile(r), tile(k), tile(v), tile(w)
        wd = tile(w, past_t_decays).view(B, 4, SUB, H, N)
        sub = lambda x: x.view(B, 4, SUB, H, N)  # noqa: E731
        x = exclusive_prod(wd, 2)                 # prod from the sub-chunk's start
        ysuf = exclusive_prod(wd, 2, reverse=True)  # prod to its end
        F = wd.prod(dim=2)                        # (B, 4, H, N)
        one = torch.ones_like(F[:, 0])

        def prod_of(i0, i1):                      # prod of F_i, i0 <= i < i1
            out = one
            for i in range(i0, i1):
                out = out * F[:, i]
            return out

        R, kj = sub(rc) * x, sub(kc) * ysuf
        RD = torch.stack([R[:, j] * prod_of(0, j)[:, None] for j in range(4)], 1)
        KT = torch.stack([kj[:, j] * prod_of(j + 1, 4)[:, None]
                          for j in range(4)], 1)
        flat = lambda x: x.reshape(B, CHUNK, H, N)  # noqa: E731
        y = both_split("bthn,bhnm->bthm", flat(RD), S, terms)       # P1
        A = torch.zeros(B, H, CHUNK, CHUNK)
        for j in range(3):                                          # P2
            for ws in range(j + 1, 4):
                Q = R[:, ws] * prod_of(j + 1, ws)[:, None]
                A[:, :, SUB * ws:SUB * ws + SUB, SUB * j:SUB * j + SUB] = \
                    both_split("bthn,bshn->bhts", Q, kj[:, j], terms)
        rs, ks, wr = sub(rc), sub(kc), sub(w_raw)                   # diagonal
        for t in range(SUB):
            q = rs[:, :, t]
            A[..., t::SUB, t::SUB].diagonal(dim1=-2, dim2=-1).copy_(
                (q * u * ks[:, :, t]).sum(-1).transpose(1, 2))
            for s in range(t - 1, -1, -1):
                blk = (q * ks[:, :, s]).sum(-1).transpose(1, 2)     # (B, H, 4)
                A[..., t::SUB, s::SUB].diagonal(dim1=-2, dim2=-1).copy_(blk)
                q = q * wr[:, :, s]
        y = y + one_split("bhts,bshm->bthm", A, vc, terms)          # P3
        S = prod_of(0, 4)[..., None] * S \
            + one_split("bshn,bshm->bhnm", flat(KT), vc, terms)     # P4
        ys.append(y[:, :n])
    return torch.cat(ys, dim=1), S


def bf16_inputs(B, T, H, N=64, seed=0, extreme=False):
    """bf16 r, k and v, float32 w and u, made with numpy as the time mix
    makes them (chip_smoke's rwkv_inputs): w = exp(-exp(z - 0.5)); or, with
    ``extreme``, w = exp(-exp(3 z - 3)), exactly 0 at every 7th channel and
    exactly 1 at channels 1, 10, 19, ..."""
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    r, k, v = (f(B, T, H, N).bfloat16() for _ in range(3))
    z = f(B, T, H, N)
    if extreme:
        w = torch.exp(-torch.exp(3 * z - 3))
        w[..., ::7] = 0.0
        w[..., 1::9] = 1.0
    else:
        w = torch.exp(-torch.exp(z - 0.5))
    return r, k, v, w, f(H, N) * H ** -0.5


def readings(got, want):
    """chip_smoke's verdict for y and for the state: (ok, ok)."""
    return (CS.ssd_agreement(got[0], want[0])[0],
            CS.ssd_agreement(got[1], want[1])[0])


def jax_reference(ins):
    """y from the JAX package's Pallas kernel (interpret mode) and the final
    state from its plain scan, fed steps with w = 1 and k = v = 0 up to a
    whole chunk (its own padding zeroes the state, ROADMAP C7)."""
    r, k, v, w, u = (t.float().numpy() for t in ins)
    T = r.shape[1]
    y = JRK.rwkv6_scan(*map(jnp.asarray, (r, k, v, w, u)), bt=CHUNK)
    pad = ((0, 0), (0, (-T) % CHUNK), (0, 0), (0, 0))
    _, S = JB._rwkv_scan_ref(*map(jnp.asarray, (
        np.pad(r, pad), np.pad(k, pad), np.pad(v, pad),
        np.pad(w, pad, constant_values=1.0), u)))
    return torch.from_numpy(np.array(y)), torch.from_numpy(np.array(S))


def test_the_kernel_cuts_each_float32_operand_into_bf16_terms():
    """The source sets the term count the emulation uses; one term is the
    plain bf16 product, which the test below shows is not enough."""
    assert TERMS >= 2


def test_terms_are_cut_as_the_shared_split_cuts_them():
    """The emulation's terms are those of ``hopper.cuh``'s ``split``, which
    rounds once and then truncates: the source has one rounding conversion
    and the truncating mask; the first term is x rounded, each later one
    within 2^-7 of what is left and no larger, and three terms leave less
    than 2^-22 of x, down to float32's smallest normal numbers."""
    body = re.search(r"void split\(.*?\n}\n", HEADER.read_text(), re.S).group(0)
    assert body.count("_rn(") == 1 and "0xffff0000u" in body
    rng = np.random.RandomState(3)
    x = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -30, 30, 4096)).astype(np.float32))
    terms = bf16_terms(x, 3)
    assert torch.equal(terms[0], x.bfloat16().float())
    rest = x - terms[0]
    for t in terms[1:]:
        assert torch.equal(t, t.bfloat16().float())
        assert (t.abs() <= rest.abs()).all()
        assert ((rest - t).abs() <= rest.abs() * 2.0 ** -7).all()
        rest = rest - t
    assert ((x - sum(terms)).abs() <= x.abs() * 2.0 ** -22).all()


@pytest.mark.parametrize("T", [64, 65, 100, 512])
def test_emulated_body_meets_the_chip_limits(T):
    """At N = 64, whole chunks, a chunk and a step, a ragged tail and
    rwkv6-3b's prefill length, with the kernel's term count: against the
    port's plain scan, the JAX Pallas kernel (y) and the JAX plain scan
    (the final state)."""
    B, H = (1, 2) if T == 512 else (2, 3)
    ins = bf16_inputs(B, T, H, seed=T)
    got = emulate(*ins, TERMS)
    assert readings(got, RR.rwkv6_scan_ref(*ins)) == (True, True)
    assert readings(got, jax_reference(ins)) == (True, True)


@pytest.mark.parametrize("T", [100, 130])
def test_extreme_decays_meet_the_chip_limits(T):
    """Decays from 1 down to underflow, exact zeros and exact ones: the
    products of w never divide, so nothing is lost that matters."""
    ins = bf16_inputs(2, T, 3, seed=7, extreme=True)
    w = ins[3]
    assert (w == 0).any() and (w == 1).any() and (w[w > 0].min() < 1e-30)
    got = emulate(*ins, TERMS)
    assert all(torch.isfinite(x).all() for x in got)
    assert readings(got, RR.rwkv6_scan_ref(*ins)) == (True, True)
    assert readings(got, jax_reference(ins)) == (True, True)


def test_exact_operands_give_the_plain_scan():
    """With every float32 operand kept whole (enough terms to be exact),
    the chunked form agrees with the plain scan far inside the limits: what
    the term count leaves is the only error the plan adds."""
    ins = bf16_inputs(2, 130, 3, seed=1)
    y, S = emulate(*ins, terms=6)
    y_ref, S_ref = RR.rwkv6_scan_ref(*ins)
    for got, want in ((y, y_ref), (S, S_ref)):
        ok, _, rel, elem = CS.ssd_agreement(got, want)
        assert ok and rel < CS.SSD_REL_L2 / 5 and elem < 0.5


def test_one_bf16_term_fails_the_chip_limits():
    """A single bf16 term of every float32 operand, at T = 512: the limits
    reject it, by y and by the state."""
    ins = bf16_inputs(2, 512, 2, seed=2)
    ok_y, ok_s = readings(emulate(*ins, terms=1), RR.rwkv6_scan_ref(*ins))
    assert not ok_y and not ok_s


@pytest.mark.parametrize("T", [65, 100])
def test_state_zero_padded_to_a_whole_chunk_is_rejected(T):
    """The trap of a ragged last chunk: decays that took TMA's zero-filled
    w past T would wipe the state. The limits reject both chip_smoke's
    planted fault and the body's form with those decays, while y keeps its
    rows before T."""
    ins = bf16_inputs(2, T, 3, seed=T)
    y_ref, S_ref = RR.rwkv6_scan_ref(*ins)
    fy, fs = CS.plain_rwkv(*ins, "state zero-padded to a whole chunk")
    assert CS.ssd_agreement(fy, y_ref)[0]
    assert not CS.ssd_agreement(fs, S_ref)[0]
    y, S = emulate(*ins, TERMS, past_t_decays=0.0)
    assert CS.ssd_agreement(y, y_ref)[0]
    assert not CS.ssd_agreement(S, S_ref)[0]
