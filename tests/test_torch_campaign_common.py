"""Helpers shared by the port's campaign and simulator tests, which hold
the port against the JAX package on the CPU: ``same_cell`` runs one
scenario x workload cell through both packages' ``run_scenario``, and
``PACKAGES``, ``Endpoint``, ``shift_pair`` and ``simple_step`` set up
``tests/test_shift.py``'s SHIFT pair over either package's own fabric.
The module holds no test of its own."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import scenarios as J  # noqa: E402
from repro.core import fabric as j_fabric  # noqa: E402
from repro.core import protocols as j_protocols  # noqa: E402
from repro.core import shift as j_shift  # noqa: E402
from repro.core import verbs as j_verbs  # noqa: E402
from repro_torch import scenarios as T  # noqa: E402
from repro_torch.core import fabric as t_fabric  # noqa: E402
from repro_torch.core import protocols as t_protocols  # noqa: E402
from repro_torch.core import shift as t_shift  # noqa: E402
from repro_torch.core import verbs as t_verbs  # noqa: E402

PACKAGES = {"ref": (j_fabric, j_shift, j_verbs, j_protocols),
            "port": (t_fabric, t_shift, t_verbs, t_protocols)}


def same_cell(name: str, workload: str, port_kw=None, **kw):
    """Run ``name`` x ``workload`` through both packages with ``kw`` (and
    ``port_kw`` on the port only), hold the fingerprints, the violations
    and the payload mismatches equal; returns (port, reference)."""
    port = T.run_scenario(T.SCENARIOS[name], workload=workload,
                          **{**kw, **(port_kw or {})})
    ref = J.run_scenario(J.SCENARIOS[name], workload=workload, **kw)
    assert port.violations == ref.violations
    assert port.fingerprint() == ref.fingerprint()
    assert port.payload_mismatches == ref.payload_mismatches
    return port, ref


class Endpoint:
    """One application endpoint over an RDMA library (as
    ``tests/test_shift.py``'s)."""

    def __init__(self, V, lib, nic="mlx5_0", buf_size=1 << 20):
        self.lib = lib
        self.ctx = lib.open_device(nic)
        self.pd = lib.alloc_pd(self.ctx)
        self.buf = np.zeros(buf_size, dtype=np.uint8)
        self.mr = lib.reg_mr(self.pd, self.buf)
        self.cq = lib.create_cq(self.ctx, 65536)
        self.qp = lib.create_qp(self.pd, V.QPInitAttr(
            send_cq=self.cq, recv_cq=self.cq,
            cap=V.QPCap(max_send_wr=4096, max_recv_wr=4096)))

    def poll(self, n=1024):
        return self.lib.poll_cq(self.cq, n)


def shift_pair(pkg: str, probe_interval=5e-3):
    """``tests/test_shift.py``'s ``make_shift_pair`` on ``pkg``'s fabric."""
    fabric, S, V, _ = PACKAGES[pkg]
    V.reset_registries()
    c = fabric.build_cluster(n_hosts=2, nics_per_host=2)
    cfg = S.ShiftConfig(probe_interval=probe_interval)
    lib_a = S.ShiftLib(c, "host0", config=cfg)
    lib_b = S.ShiftLib(c, "host1", kv=lib_a.kv, config=cfg)
    a, b = Endpoint(V, lib_a), Endpoint(V, lib_b)
    lib_a.connect(a.qp, *lib_b.route_of(b.qp))
    lib_b.connect(b.qp, *lib_a.route_of(a.qp))
    lib_a.settle(0.05)
    assert a.qp.ready and b.qp.ready
    return c, a, b


def simple_step(V, a, b, seq, size):
    """One NCCL-Simple message a -> b: bulk write, then write-with-imm."""
    off = (seq % 8) * size
    a.buf[off:off + size] = (seq % 251) + 1
    b.lib.post_recv(b.qp, V.RecvWR(wr_id=50_000 + seq))
    a.lib.post_send(a.qp, V.SendWR(
        wr_id=seq * 2, opcode=V.Opcode.WRITE,
        sge=V.SGE(a.mr.addr + off, size, a.mr.lkey),
        remote_addr=b.mr.addr + off, rkey=b.mr.rkey, send_flags=0))
    a.lib.post_send(a.qp, V.SendWR(
        wr_id=seq * 2 + 1, opcode=V.Opcode.WRITE_IMM, sge=None,
        remote_addr=0, rkey=b.mr.rkey, imm_data=seq,
        send_flags=V.SEND_FLAG_SIGNALED))
