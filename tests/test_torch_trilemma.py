"""The port's copy of the trilemma model (``repro_torch.core.trilemma``)
and the simulator runs of ``tests/test_trilemma.py``, against the JAX
package's, on the CPU.

Each case of ``tests/test_trilemma.py`` runs on the port's copy, with the
same assertion, and its result must equal the reference's: the traces
and sender views (events compared by kind, operation and payload), the
decision verdicts, the non-idempotency witnesses, the consensus race,
the protocol table, and two runs of each package's own simulator (a
Simple stream across a NIC failure and recovery, and the naive LL
failover that corrupts a reused slot). The property sweeps of the
reference run here over fixed values.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import protocols as j_protocols  # noqa: E402
from repro.core import trilemma as JT  # noqa: E402
from repro.core import verbs as j_verbs  # noqa: E402
from repro_torch.core import protocols as t_protocols  # noqa: E402
from repro_torch.core import trilemma as TT  # noqa: E402
from repro_torch.core import verbs as t_verbs  # noqa: E402

from test_torch_campaign_common import (PACKAGES, Endpoint,  # noqa: E402
                                        shift_pair, simple_step)


def plain(x):
    """A trace, event, operation or memory in package-free terms: enums by
    value, dataclasses by class name and fields."""
    if isinstance(x, tuple):
        return tuple(plain(e) for e in x)
    if hasattr(x, "kind") and hasattr(x, "payload"):
        return ("Event", x.kind.value, plain(x.op), x.payload)
    if hasattr(x, "__dataclass_fields__"):
        return (type(x).__name__,) + tuple(
            getattr(x, f) for f in x.__dataclass_fields__)
    if hasattr(x, "_m"):
        return ("Memory", dict(x._m))
    return x


# ---------------------------------------------------------------------------
# Lemma 3.1: indistinguishability
# ---------------------------------------------------------------------------


def test_traces_and_sender_views_equal_reference():
    t1, t2 = TT.trace_packet_lost(), TT.trace_ack_lost()
    assert TT.sender_view(t1) == TT.sender_view(t2)
    assert t1 != t2
    assert plain(t1) == plain(JT.trace_packet_lost())
    assert plain(t2) == plain(JT.trace_ack_lost())
    assert plain(TT.sender_view(t2)) == plain(JT.sender_view(
        JT.trace_ack_lost()))
    for retransmit in (False, True):
        for name in ("trace_packet_lost", "trace_ack_lost"):
            got = TT.final_memory(getattr(TT, name)(), retransmit)
            want = JT.final_memory(getattr(JT, name)(), retransmit)
            assert (plain(got[0]), got[1]) == (plain(want[0]), want[1])
    assert (TT.A_DATA, TT.V1, TT.V_NEW) == (JT.A_DATA, JT.V1, JT.V_NEW)
    assert [e.value for e in TT.SENDER_OBSERVABLE] == \
        [e.value for e in JT.SENDER_OBSERVABLE]


def test_fixed_decisions_violate_one_property():
    for decide, broken in ((lambda view: False, "liveness"),
                           (lambda view: True, "safety")):
        assert TT.decision_violates(decide) == broken
        assert JT.decision_violates(decide) == broken


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 255, 4096, 2 ** 16 - 1])
def test_any_deterministic_decision_function_fails(seed):
    """Theorem 3.3: a hash-indexed decision function of the sender view
    violates liveness or safety, the same one in both packages (the
    views hash alike: frozen dataclasses of equal fields, enums by
    name)."""

    def decide(view):
        return bool((hash(view) ^ seed) & 1)

    got = TT.decision_violates(decide)
    assert got in ("liveness", "safety")
    assert got == JT.decision_violates(decide)


# ---------------------------------------------------------------------------
# Lemma 3.2: non-idempotency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("delta", [1, 5, 77, 10 ** 6])
def test_fadd_non_idempotent_any_delta(delta):
    assert TT.fadd_non_idempotent(delta=delta)
    assert TT.fadd_non_idempotent(delta=delta) == \
        JT.fadd_non_idempotent(delta=delta)


def test_witnesses_equal_reference():
    assert TT.fadd_non_idempotent() and JT.fadd_non_idempotent()
    assert TT.cas_double_success() and JT.cas_double_success()
    assert TT.send_non_idempotent() and JT.send_non_idempotent()
    corrupted, observed = TT.ll_write_after_reuse()
    assert corrupted and observed == TT.V1
    assert (corrupted, observed) == JT.ll_write_after_reuse()


def test_exec_op_equals_reference():
    ops = [("Write", (0, 3)), ("FADD", (0, 4)), ("CAS", (0, 7, 1)),
           ("CAS", (0, 7, 2)), ("Read", (0,)), ("FADD", (8, -2))]
    mt, mj = TT.Memory(), JT.Memory()
    for name, args in ops:
        assert TT.exec_op(mt, getattr(TT, name)(*args)) == \
            JT.exec_op(mj, getattr(JT, name)(*args))
    assert plain(mt) == plain(mj)
    with pytest.raises(TypeError):
        TT.exec_op(mt, object())


# ---------------------------------------------------------------------------
# Theorem 3.4: consensus barrier
# ---------------------------------------------------------------------------


def test_rw_registers_cannot_build_sticky_register():
    decided = TT.rw_register_consensus_attempt()
    assert "ghost" in decided and "backup" in decided
    assert decided == JT.rw_register_consensus_attempt()


# ---------------------------------------------------------------------------
# protocol classification (§3.2 Table 1)
# ---------------------------------------------------------------------------


def test_protocol_table_equals_reference():
    P, F = t_protocols.Protocol, t_protocols.FailoverClass
    assert t_protocols.PROTOCOL_CLASS[P.NCCL_SIMPLE] is F.SAFE
    assert t_protocols.PROTOCOL_CLASS[P.NCCL_LL] is F.UNSAFE_PACKED
    assert {p.name: c.name for p, c in t_protocols.PROTOCOL_CLASS.items()} \
        == {p.name: c.name for p, c in j_protocols.PROTOCOL_CLASS.items()}


@pytest.mark.parametrize("opcodes", [("WRITE",), ("WRITE", "FETCH_ADD"),
                                     ("WRITE_IMM", "CMP_SWAP"), ("SEND",)])
def test_classify_wqe_set_equals_reference(opcodes):
    class W:
        def __init__(self, op):
            self.opcode = op

    got = t_protocols.classify_wqe_set(
        [W(getattr(t_verbs.Opcode, o)) for o in opcodes])
    want = j_protocols.classify_wqe_set(
        [W(getattr(j_verbs.Opcode, o)) for o in opcodes])
    assert got.name == want.name


# ---------------------------------------------------------------------------
# the simulator runs, each package over its own fabric
# ---------------------------------------------------------------------------


def simple_stream(pkg, fail_at, recover_at, kill, n_msgs=24, size=4096):
    """``tests/test_trilemma.py``'s stream: ``kill`` fails at ``fail_at``
    and recovers ``recover_at`` later. Returns what the sender and the
    receiver saw."""
    V = PACKAGES[pkg][2]
    c, a, b = shift_pair(pkg)
    recv_wcs, send_wcs = [], []
    next_seq = [0]

    def pump():
        if next_seq[0] < n_msgs:
            simple_step(V, a, b, next_seq[0], size)
            next_seq[0] += 1
            c.sim.schedule(120e-6, pump)
        recv_wcs.extend(b.poll())
        send_wcs.extend(a.poll())

    pump()
    t0 = c.sim.now
    c.sim.at(t0 + fail_at, c.fail_nic, kill)
    c.sim.at(t0 + fail_at + recover_at, c.recover_nic, kill)
    c.sim.run(until=t0 + 1.5)
    recv_wcs.extend(b.poll())
    send_wcs.extend(a.poll())
    imms = [w.imm_data for w in recv_wcs
            if w.opcode is V.WCOpcode.RECV_RDMA_WITH_IMM and not w.is_error]
    return {"imms": imms,
            "send_ok": sum(1 for w in send_wcs if not w.is_error),
            "send_wr_ids": [w.wr_id for w in send_wcs],
            "fallbacks": a.lib.stats.fallbacks + b.lib.stats.fallbacks,
            "recoveries": a.lib.stats.recoveries + b.lib.stats.recoveries,
            "now": c.sim.now, "events": c.sim._executed}


@pytest.mark.parametrize("fail_at,recover_at,kill,fallbacks", [
    (1e-5, 1e-4, "host0/mlx5_0", 0), (5e-4, 2e-3, "host1/mlx5_0", 0),
    (5e-4, 10e-3, "host0/mlx5_0", 2), (1e-3, 40e-3, "host1/mlx5_0", 2),
    (1.3e-3, 30e-3, "host0/mlx5_0", 2), (2e-3, 5e-3, "host1/mlx5_0", 2)])
def test_notification_exactly_once_in_order_equals_reference(
        fail_at, recover_at, kill, fallbacks):
    """Outages shorter than the RC retry budget are ridden out (no
    fallback); longer ones fail over and back."""
    port = simple_stream("port", fail_at, recover_at, kill)
    assert port["imms"] == list(range(24))
    assert port["send_ok"] == 24
    assert port["fallbacks"] == fallbacks
    assert port == simple_stream("ref", fail_at, recover_at, kill)


def naive_ll_failover(pkg):
    """``tests/test_trilemma.py``'s naive LL failover (Lemma C.5) on
    ``pkg``'s fabric: returns the slot before and after the naive
    retransmission."""
    fabric, S, V, protocols = PACKAGES[pkg]
    V.reset_registries()
    c = fabric.build_cluster(n_hosts=2, nics_per_host=2)
    lib_a, lib_b = S.StandardLib(c, "host0"), S.StandardLib(c, "host1")
    a, b = Endpoint(V, lib_a), Endpoint(V, lib_b)
    lib_a.connect(a.qp, *lib_b.route_of(b.qp))
    lib_b.connect(b.qp, *lib_a.route_of(a.qp))
    ll = protocols.LLChannel(b.mr)
    a.buf[:8] = np.frombuffer(protocols.LLChannel.pack(77, 1),
                              dtype=np.uint8)
    a.lib.post_send(a.qp, V.SendWR(
        wr_id=1, opcode=V.Opcode.WRITE, sge=V.SGE(a.mr.addr, 8, a.mr.lkey),
        remote_addr=b.mr.addr, rkey=b.mr.rkey))
    lat = c.path_latency(c.nic_by_gid["host0/mlx5_0"],
                         c.nic_by_gid["host1/mlx5_0"])
    down = V.PER_MESSAGE_OVERHEAD + 8 / 12.5e9 + lat + 1e-7
    c.sim.at(c.sim.now + down, c.fail_nic, "host0/mlx5_0")
    c.sim.run(until=c.sim.now + 0.1)
    before = ll.poll_slot(0, 1)
    ll.reuse_slot(0, data=55, seq=1)
    ctx_a2 = V.ibv_open_device(c, "host0", "mlx5_1")
    ctx_b2 = V.ibv_open_device(c, "host1", "mlx5_1")
    pd_a2, pd_b2 = V.ibv_alloc_pd(ctx_a2), V.ibv_alloc_pd(ctx_b2)
    mr_a2 = V.ibv_reg_mr(pd_a2, a.buf, addr=a.mr.addr)
    mr_b2 = V.ibv_reg_mr(pd_b2, b.buf, addr=b.mr.addr)
    cq2a, cq2b = V.ibv_create_cq(ctx_a2, 64), V.ibv_create_cq(ctx_b2, 64)
    qp2a = V.ibv_create_qp(pd_a2, V.QPInitAttr(send_cq=cq2a, recv_cq=cq2a))
    qp2b = V.ibv_create_qp(pd_b2, V.QPInitAttr(send_cq=cq2b, recv_cq=cq2b))
    V.connect_qps(qp2a, qp2b)
    wr = a.qp.sq[0].to_wr()
    wr.sge = V.SGE(mr_a2.addr, 8, mr_a2.lkey)
    wr.rkey = mr_b2.rkey
    V.ibv_post_send(qp2a, wr)
    c.sim.run(until=c.sim.now + 0.1)
    return before, ll.poll_slot(0, 1), bytes(b.buf[:8]), c.sim.now


def test_naive_ll_failover_corrupts_on_both_simulators():
    port = naive_ll_failover("port")
    before, after = port[:2]
    assert before == 77
    assert after == 77, "the app's 55 must be clobbered by the stale 77"
    assert port == naive_ll_failover("ref")
