"""The arithmetic of B3's bf16 body (``decode_attention/csrc/decode.cu``),
emulated on the CPU in PyTorch.

The body cuts each sequence's cache rows into chunks of ``CHUNK`` rows (the
source's ``BS``). For each chunk and K/V head it forms S = K q^T from the
bf16 values with float32 sums, scales S in float32 after the product (q is
never rounded with the scale), takes the chunk's max a head and P = exp(S -
max) in float32, the sum of P from that float32 P, and O^T = V^T P^T with P
cut into ``P_TERMS`` bf16 terms (the source's count; ``hopper.cuh``'s
``split``: the first rounded to nearest, each later one truncated); at G =
1 the products run on the CUDA cores, with P in float32. A row
whose length fits one chunk is o / l at once; otherwise the chunks are
combined in chunk order: M the max of their maxes, L = sum of exp(m - M) l
and O = sum of exp(m - M) o, then O / L. A length <= 0 gives a zero row
(ROADMAP C6). The emulation repeats that arithmetic and is held, under
``chip_smoke.py``'s limits for B3 (``TOL`` and ``REL_L2``, which hold the
kernel against the plain version on the card), against the port's plain
version and against the JAX package's ``decode_attention`` (its Pallas
kernel in interpret mode, one call a row for its scalar length), at
yi-6b's serving shape and zamba2's decode shape. The emulation lives here
and not in the package: nothing on the main path calls it.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import kernel as JDK  # noqa: E402
from repro_torch.kernels.decode_attention import ref as DR  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402

SOURCE = (ROOT / "src/repro_torch/kernels/decode_attention/csrc/decode.cu"
          ).read_text()
CHUNK = int(re.search(r"constexpr int BS = (\d+);", SOURCE).group(1))
P_TERMS = int(re.search(r"constexpr int P_TERMS = (\d+);", SOURCE).group(1))

# (label, B, H, KV, S, hd, lens), as chip_smoke times them
YI_SERVING = ("yi-6b serving", 4, 32, 4, CS.SERVE_MAX_LEN, 128,
              [n + CS.N_NEW // 2 for n in CS.PROMPT_LENS])
ZAMBA_DECODE = ("zamba2 decode", 4, 32, 32, CS.SERVE_MAX_LEN, 64, [528] * 4)


def bf16_terms(x: torch.Tensor, k: int) -> list:
    """float32 ``x`` as ``k`` bf16 terms (as float32), as ``hopper.cuh``'s
    ``split`` cuts them: x rounded to nearest, then each remainder truncated
    (its low 16 bits dropped)."""
    out = [x.bfloat16().float()]
    for _ in range(k - 1):
        x = x - out[-1]
        out.append((x.view(torch.int32) & -65536).view(torch.float32))
    return out


def emulate(q, kc, vc, lens, terms="kernel"):
    """The bf16 body's arithmetic: o (B, H, hd) in q's dtype. ``terms``:
    P's bf16 terms in O^T = V^T P^T (None: P in float32; "kernel": as the
    kernel has it, ``P_TERMS``, or float32 at G = 1)."""
    B, H, hd = q.shape
    S, KV = kc.shape[1], kc.shape[2]
    G, scale = H // KV, hd ** -0.5
    if terms == "kernel":
        terms = None if G == 1 else P_TERMS
    qf, kf, vf = q.float(), kc.float(), vc.float()
    out = torch.zeros(B, H, hd)
    for b in range(B):
        n = min(max(int(lens[b]), 0), S)
        for c in range(KV):
            qg = qf[b, c * G:(c + 1) * G]                      # (G, hd)
            parts = []
            for s0 in range(0, n, CHUNK):
                k = kf[b, s0:min(s0 + CHUNK, n), c]            # (rows, hd)
                v = vf[b, s0:min(s0 + CHUNK, n), c]
                s = (k @ qg.T) * scale                         # (rows, G)
                m = s.amax(0)
                p = torch.exp(s - m)
                ps = [p] if terms is None else bf16_terms(p, terms)
                parts.append((m, p.sum(0), sum(v.T @ t for t in ps)))
            if not parts:                                      # C6
                continue
            if len(parts) == 1:
                _, acc, o = parts[0]
            else:
                M = torch.stack([m for m, _, _ in parts]).amax(0)
                acc, o = torch.zeros(G), torch.zeros(hd, G)
                for m, l, oc in parts:                         # chunk order
                    w = torch.exp(m - M)
                    acc = acc + w * l
                    o = o + w * oc
            out[b, c * G:(c + 1) * G] = (o / acc.clamp_min(1e-30)).T
    return out.to(q.dtype)


def inputs(B, H, KV, S, hd, seed):
    """bf16 q (B, H, hd) and caches (B, S, KV, hd), made with numpy."""
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*s).astype(np.float32))
                 .bfloat16() for s in ((B, H, hd), (B, S, KV, hd),
                                       (B, S, KV, hd)))


def jax_reference(q, kc, vc, lens):
    """The JAX package's decode attention (Pallas, interpret mode), one call
    a row for its scalar length, in bf16: its caches are (B, KV, S, hd)."""
    S = kc.shape[1]
    rows = []
    for b, n in enumerate(lens):
        qj, kj, vj = (jnp.asarray(t[b:b + 1].float().numpy())
                      for t in (q, kc, vc))
        rows.append(np.array(JDK.decode_attention(
            qj, kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
            min(max(n, 0), S), bk=S)))
    return torch.from_numpy(np.concatenate(rows)).bfloat16()


def holds(got, want) -> bool:
    return CS.agreement("decode_attention", got, want)[0]


def test_the_source_sets_the_chunk_rows_and_p_terms():
    """The emulation reads both from the kernel's source: 64-row chunks,
    and P cut by the shared ``split`` into at least one bf16 term, except
    at G = 1, which the CUDA-core body takes."""
    assert CHUNK == 64 and P_TERMS >= 1
    assert "split(pr[0], pr[1], lo)" in SOURCE
    assert "uint32_t p[P_TERMS][BS][HEADS / 2]" in SOURCE
    assert "if (G == 1)\n    decode_kernel<HD, true>" in SOURCE


@pytest.mark.parametrize("case", [YI_SERVING, ZAMBA_DECODE],
                         ids=lambda c: c[0])
def test_emulated_body_meets_the_chip_limits(case):
    """At yi-6b's serving shape (3, 5, 7 and 9 chunks a row) and zamba2's
    decode shape (9 chunks, G = 1): against the port's plain version and
    the JAX package's Pallas kernel."""
    _, B, H, KV, S, hd, lens = case
    q, kc, vc = inputs(B, H, KV, S, hd, seed=hd)
    got = emulate(q, kc, vc, lens)
    assert holds(got, DR.decode_attention_ref(q, kc, vc, torch.tensor(lens)))
    assert holds(got, jax_reference(q, kc, vc, lens))


@pytest.mark.parametrize("lens", [[0, 77, 199, 200], [1, 17, 63, 64],
                                  [200, 65, 130, 0]],
                         ids=["empty row", "one chunk each",
                              "chunk counts differ"])
def test_emulated_paths_meet_the_chip_limits(lens):
    """A length-0 row gives 0 in all three; every row in one chunk (o
    written at once); chunk counts that differ within the batch and reach
    the last, partial chunk of S = 200."""
    q, kc, vc = inputs(4, 16, 2, 200, 64, seed=sum(lens))
    got = emulate(q, kc, vc, lens)
    ref = DR.decode_attention_ref(q, kc, vc, torch.tensor(lens))
    jax = jax_reference(q, kc, vc, lens)
    empty = torch.tensor(lens) == 0
    for o in (got, ref, jax):
        assert torch.all(o[empty] == 0)
        assert torch.all(o[~empty].abs().amax(-1) > 0)
    assert holds(got, ref)
    assert holds(got, jax)


def test_float32_p_gives_the_plain_version():
    """With P kept in float32, the chunked form with its ordered combine
    agrees with the plain version far inside the limits: the bf16 terms of
    P are the only error the plan adds, and they stay within them."""
    _, B, H, KV, S, hd, lens = YI_SERVING
    q, kc, vc = inputs(B, H, KV, S, hd, seed=5)
    ref = DR.decode_attention_ref(q, kc, vc, torch.tensor(lens))
    for terms, margin in ((None, 5), ("kernel", 1)):
        ok, _, rel = CS.agreement("decode_attention",
                                  emulate(q, kc, vc, lens, terms), ref)
        assert ok and rel <= CS.REL_L2["bfloat16"] / margin
