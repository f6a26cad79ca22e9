"""The precision plan of B4's bf16 body (``ssm_scan/csrc/ssd_scan.cu``),
emulated on the CPU in PyTorch.

The body runs the chunked SSD form over 64-step chunks on bf16 tensor
cores with float32 sums: C B^T straight from the bf16 inputs, and each
product with a float32 operand (G = (C B^T) o L o dt, the state h, and
w o B) as the sum of products of that operand's bf16 terms (its value
rounded, then what that leaves truncated, ...: ``hopper.cuh``'s
``split``), ``TERMS`` of them, the count the source sets. The emulation
repeats that arithmetic and is held, under ``chip_smoke.py``'s SSD_REL_L2
and SSD_TOL (the limits that hold the kernel against the plain scan on the
card), against the port's plain scan and against the JAX package's scan:
its Pallas kernel in interpret mode for y, its reference scan for the
final state. One bf16 term fails those limits. The emulation lives here and not in the package: nothing on
the main path calls it.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import kernel as JSK  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as SR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

SOURCE = ROOT / "src/repro_torch/kernels/ssm_scan/csrc/ssd_scan.cu"
TERMS = int(re.search(r"constexpr int TERMS = (\d+);",
                      SOURCE.read_text()).group(1))
CHUNK = 64
LOG2E = 1.4426950408889634


def bf16_terms(x: torch.Tensor, k: int) -> list:
    """float32 ``x`` as ``k`` bf16 terms (as float32), as ``hopper.cuh``'s
    ``split`` cuts them: x rounded to nearest, then each remainder truncated
    (its low 16 bits dropped); every remainder is exact in float32."""
    out = [x.bfloat16().float()]
    for _ in range(k - 1):
        x = x - out[-1]
        out.append((x.view(torch.int32) & -65536).view(torch.float32))
    return out


def emulate(xh, dt, A, Bm, Cm, terms: int):
    """The bf16 body's arithmetic: (y (B, T, H, P), final state (B, H, P,
    N)), float32. In log2 units, cum is the prefix sum of dt A within a
    chunk, G[t, s] = (C B^T)[t, s] 2^(cum[t] - cum[s]) dt[s] for s <= t,
    y = G x + 2^cum (C h^T) and h <- 2^cum[-1] h + x^T (w o B) with
    w[s] = 2^(cum[-1] - cum[s]) dt[s]."""
    B, T, H, P = xh.shape
    N = Bm.shape[-1]
    x, d, b, c = xh.float(), dt.float(), Bm.float(), Cm.float()
    a2 = A.float() * LOG2E
    h = torch.zeros(B, H, P, N)
    ys = []
    for t0 in range(0, T, CHUNK):
        part = slice(t0, min(T, t0 + CHUNK))
        r = part.stop - t0
        dc = d[:, part]                                   # (B, r, H)
        cum = torch.cumsum(dc * a2, dim=1)
        seen = torch.tril(torch.ones(r, r, dtype=torch.bool))[None, :, :, None]
        s = torch.einsum("btn,bsn->bts", c[:, part], b[:, part])
        diff = (cum[:, :, None] - cum[:, None]).masked_fill(~seen, 0.0)
        g = (s[..., None] * torch.exp2(diff) * dc[:, None]).masked_fill(
            ~seen, 0.0)                                   # (B, t, s, H)
        intra = sum(torch.einsum("btsh,bshp->bthp", gk, x[:, part])
                    for gk in bf16_terms(g, terms))
        inter = sum(torch.einsum("btn,bhpn->bthp", c[:, part], hk)
                    for hk in bf16_terms(h, terms))
        ys.append(intra + torch.exp2(cum)[..., None] * inter)
        total = cum[:, -1]                                # (B, H)
        w = torch.exp2(total[:, None] - cum) * dc         # (B, r, H)
        wb = w[..., None] * b[:, part, None, :]           # (B, r, H, N)
        h = torch.exp2(total)[..., None, None] * h + sum(
            torch.einsum("bshp,bshn->bhpn", x[:, part], wk)
            for wk in bf16_terms(wb, terms))
    return torch.cat(ys, dim=1), h


def bf16_inputs(B, T, H, P=64, N=64, seed=0):
    """bf16 (xh, dt, Bm, Cm) and float32 A, made with numpy as the Mamba2
    block makes them: dt = softplus(.) > 0, A = -exp(.) < 0."""
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa: E731
    xh, dt = f(B, T, H, P), torch.nn.functional.softplus(f(B, T, H))
    A = -torch.exp(0.3 * f(H))
    Bm, Cm = f(B, T, N), f(B, T, N)
    bf = torch.bfloat16
    return xh.to(bf), dt.to(bf), A, Bm.to(bf), Cm.to(bf)


def readings(got, want):
    """chip_smoke's verdict for y and for the state: (ok, ok)."""
    return (CS.ssd_agreement(got[0], want[0])[0],
            CS.ssd_agreement(got[1], want[1])[0])


def test_the_kernel_cuts_each_float32_operand_into_bf16_terms():
    """The source sets the term count the emulation uses; one term is the
    plain bf16 product, which the tests below show is not enough."""
    assert TERMS >= 2


@pytest.mark.parametrize("T", [63, 65, 130])
def test_emulated_body_meets_the_chip_limits(T):
    """At P = N = 64 and chunk edges on both sides, with the kernel's term
    count: against the port's plain scan, the JAX Pallas kernel (interpret
    mode) and the JAX reference scan, y and the final state."""
    ins = bf16_inputs(2, T, 4, seed=T)
    got = emulate(*ins, TERMS)
    assert readings(got, SR.ssd_scan_ref(*ins)) == (True, True)
    jin = [jnp.asarray(t.float().numpy()) for t in ins]
    y_pallas = JSK.ssd_scan(*jin, bt=CHUNK)
    _, h_jax = JB._ssd_scan_ref(*jin)
    want = (torch.from_numpy(np.asarray(y_pallas)),
            torch.from_numpy(np.asarray(h_jax)))
    assert readings(got, want) == (True, True)


def test_exact_operands_give_the_plain_scan():
    """With every float32 operand kept whole (enough terms to be exact),
    the chunked form agrees with the plain scan far inside the limits: what
    the term count leaves is the only error the plan adds."""
    ins = bf16_inputs(2, 130, 4, seed=1)
    y, h = emulate(*ins, terms=6)
    y_ref, h_ref = SR.ssd_scan_ref(*ins)
    for got, want in ((y, y_ref), (h, h_ref)):
        ok, _, rel, elem = CS.ssd_agreement(got, want)
        assert ok and rel < CS.SSD_REL_L2 / 5 and elem < 0.5


def test_one_bf16_term_fails_the_chip_limits():
    """A single bf16 term of G, h and w o B, at T = 512: the limits reject
    it, by y and by the state."""
    ins = bf16_inputs(2, 512, 4, seed=2)
    got = emulate(*ins, terms=1)
    ok_y, ok_h = readings(got, SR.ssd_scan_ref(*ins))
    assert not ok_y and not ok_h
