"""The port's own copy of the fabric (``repro_torch.core``,
``repro_torch.collectives``) against the JAX package's, on the CPU.

The port imports nothing of ``jax`` or ``repro``, at any depth: a static
scan of every import statement in ``src/repro_torch`` (function-level and
lazy imports included). The same all-reduce of the smoke trainer's flat
gradient, on the same world geometry and inputs, gives the same bytes,
the same virtual clock and the same statistics in both packages, with a
NIC failed mid-collective too. The legacy datapath's send-completion
order (ROADMAP C1) is inherited, not fixed: both packages give the same
memory and the same send-WC order on each datapath. Each package's world
is built by its own ``build_world``, and no object of one is handed to
the other (each keeps its own verbs registries).
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.collectives import build_world as j_build_world  # noqa: E402
from repro.core import fabric as j_fabric  # noqa: E402
from repro.core import shift as j_shift  # noqa: E402
from repro.core import verbs as j_verbs  # noqa: E402
from repro_torch.collectives import build_world as t_build_world  # noqa: E402
from repro_torch.configs import gpt2_124m  # noqa: E402
from repro_torch.convert import param_shapes  # noqa: E402
from repro_torch.core import fabric as t_fabric  # noqa: E402
from repro_torch.core import shift as t_shift  # noqa: E402
from repro_torch.core import verbs as t_verbs  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
sys.path.insert(0, str(REPO / "tools"))

import check_docstrings  # noqa: E402

PACKAGES = {"ref": (j_build_world, j_fabric, j_shift, j_verbs),
            "port": (t_build_world, t_fabric, t_shift, t_verbs)}


# ---------------------------------------------------------------------------
# the import rule, read from the source
# ---------------------------------------------------------------------------


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


def forbidden_imports(path: Path):
    """(line, module) of every import in ``path`` that names ``jax`` or
    ``repro`` or a submodule of either, at any nesting depth; also
    ``importlib.import_module``/``__import__`` of such a constant."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names = [node.args[0].value]
        out += [(node.lineno, n) for n in names if _forbidden(n)]
    return sorted(out)


def test_no_module_of_the_port_imports_jax_or_repro_at_any_depth():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 40
    bad = {str(p.relative_to(REPO)): hits for p in files
           if (hits := forbidden_imports(p))}
    assert not bad, bad


def test_the_import_scan_sees_lazy_and_nested_imports(tmp_path):
    mod = tmp_path / "m.py"
    mod.write_text(
        "import numpy\nimport repro_torch.core\nfrom . import x\n"
        "def f():\n    from repro.optim.compress import int8_compress\n"
        "class C:\n    def g(self):\n        if True:\n"
        "            import jax.numpy as jnp\n"
        "def h():\n    import importlib\n"
        "    return importlib.import_module('repro.core')\n"
        "import jaxlib\n")
    assert forbidden_imports(mod) == [(5, "repro.optim.compress"),
                                      (9, "jax.numpy"), (12, "repro.core")]


def test_port_fabric_modules_are_documented():
    problems = check_docstrings.check(
        packages=("src/repro_torch/core", "src/repro_torch/collectives",
                  "src/repro_torch/train"))
    assert not problems, "\n".join(problems)


# ---------------------------------------------------------------------------
# the same collective in both packages
# ---------------------------------------------------------------------------


def _smoke_grad_elems() -> int:
    """Elements of the smoke trainer's flat gradient (``build_smoke_trainer``'s
    model)."""
    cfg = gpt2_124m.smoke_config(n_layers=2, d_model=128, n_heads=4,
                                 n_kv_heads=4, d_ff=512, vocab=512)
    return sum(int(np.prod(s)) for s in param_shapes(cfg).values())


GEOMETRIES = {"2r-1ch": (2, 1, 1, False), "4r-2ch": (4, 2, 1, False),
              "4r-3ch-2pods-hier": (4, 3, 2, True)}


def _bucketed_allreduce(pkg: str, geometry, fail_at=None):
    """64 KiB-bucket all-reduce of seeded float32 vectors on ``pkg``'s own
    world; ``fail_at`` fails host1's first NIC at that virtual time.
    Returns (output bytes, sim.now, stats_snapshot(), bucket count)."""
    n_ranks, channels, n_pods, hier = geometry
    build_world = PACKAGES[pkg][0]
    cluster, _, world = build_world(n_ranks=n_ranks, channels=channels,
                                    n_pods=n_pods)
    n = _smoke_grad_elems()
    rng = np.random.RandomState(7)
    vecs = [rng.standard_normal(n).astype(np.float32)
            for _ in range(n_ranks)]
    bounds = world.aligned_bucket_bounds(n, 4, 1 << 16)
    if fail_at is not None:
        cluster.sim.at(fail_at, cluster.fail_nic, "host1/mlx5_0")
    works = []
    for lo, hi in bounds:
        part = [v[lo:hi] for v in vecs]
        works.append(world.hierarchical_allreduce_async(
            part, compress=True, feedback={}, priority="bulk") if hier
            else world.allreduce_async(part, priority="bulk"))
    world.wait_all(works)
    return (b"".join(v.tobytes() for v in vecs), cluster.sim.now,
            world.stats_snapshot(), len(bounds))


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_bucketed_allreduce_same_bytes_clock_and_stats(geometry):
    ref = _bucketed_allreduce("ref", GEOMETRIES[geometry])
    port = _bucketed_allreduce("port", GEOMETRIES[geometry])
    assert ref[3] > 4
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    # the output is the sum (flat ring) or within int8 tolerance of it
    n_ranks = GEOMETRIES[geometry][0]
    rng = np.random.RandomState(7)
    want = sum(rng.standard_normal(_smoke_grad_elems()).astype(np.float32)
               .astype(np.float64) for _ in range(n_ranks))
    got = np.frombuffer(port[0][:want.size * 4], np.float32)
    tol = 0.1 if GEOMETRIES[geometry][3] else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * n_ranks)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_nic_failed_mid_collective_same_fallbacks(geometry):
    healthy = _bucketed_allreduce("ref", GEOMETRIES[geometry])[1]
    ref = _bucketed_allreduce("ref", GEOMETRIES[geometry],
                              fail_at=healthy / 3)
    port = _bucketed_allreduce("port", GEOMETRIES[geometry],
                               fail_at=healthy / 3)
    assert ref[2]["fallbacks"] >= 1
    assert ref[1] > healthy
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]


# ---------------------------------------------------------------------------
# C1, inherited: the legacy datapath's send-WC order
# ---------------------------------------------------------------------------


def _c1_script(pkg: str, fast: bool):
    """The script [READ 1884, WRITE 8] on ``pkg``'s own standard pair (the
    shape of ``tests/test_fast_datapath.py``'s harness): (destination
    bytes, source bytes, send WCs)."""
    _, F, S, V = PACKAGES[pkg]
    V.reset_registries()
    c = F.build_cluster(n_hosts=2, nics_per_host=2)
    c.fast_datapath = fast
    libs = [S.StandardLib(c, "host0"), S.StandardLib(c, "host1")]
    eps = []
    for lib in libs:
        ctx = lib.open_device("mlx5_0")
        pd = lib.alloc_pd(ctx)
        buf = np.zeros(1 << 16, dtype=np.uint8)
        mr = lib.reg_mr(pd, buf)
        cq = lib.create_cq(ctx, 1 << 16)
        qp = lib.create_qp(pd, V.QPInitAttr(
            send_cq=cq, recv_cq=cq,
            cap=V.QPCap(max_send_wr=8192, max_recv_wr=8192)))
        eps.append((lib, buf, mr, cq, qp))
    (la, abuf, amr, acq, aqp), (lb, bbuf, bmr, _, bqp) = eps
    la.connect(aqp, *lb.route_of(bqp))
    lb.connect(bqp, *la.route_of(aqp))
    la.settle(0.05)
    rng = np.random.RandomState(1234)
    abuf[:] = rng.randint(0, 256, abuf.size, dtype=np.uint8)
    bbuf[:] = rng.randint(0, 256, bbuf.size, dtype=np.uint8)
    wrs = [V.SendWR(wr_id=i, opcode=V.Opcode[op],
                    sge=V.SGE(amr.addr, size, amr.lkey),
                    remote_addr=bmr.addr, rkey=bmr.rkey, imm_data=i)
           for i, (op, size) in enumerate([("READ", 1884), ("WRITE", 8)])]
    la.post_send_chain(aqp, wrs[:1])
    la.post_send(aqp, wrs[1])
    c.sim.run(until=c.sim.now + 1.0)
    wcs = [(w.wr_id, w.status.name, w.opcode.name)
           for w in la.poll_cq(acq, 4096)]
    return bbuf.tobytes(), abuf.tobytes(), wcs


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "legacy"])
def test_c1_send_wc_order_is_inherited_not_fixed(fast):
    ref, port = _c1_script("ref", fast), _c1_script("port", fast)
    assert port == ref
    order = [wr_id for wr_id, _, _ in port[2]]
    # RC completes in post order; the legacy datapath does not (C1)
    assert order == ([0, 1] if fast else [1, 0])
