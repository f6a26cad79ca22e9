"""Quickstart: SHIFT masking a NIC failure during an NCCL-Simple transfer.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart

The port's copy of the reference's 60-line fabric demo: numpy on the
host, no device.
"""

from __future__ import annotations

import numpy as np

from ..core import shift as S
from ..core import verbs as V
from ..core.fabric import build_cluster


def main() -> None:
    # --- a 2-host cluster, 2 rail-connected RNICs per host -----------------
    cluster = build_cluster(n_hosts=2, nics_per_host=2)
    lib_a = S.ShiftLib(cluster, "host0")
    lib_b = S.ShiftLib(cluster, "host1", kv=lib_a.kv)

    # --- standard verbs workflow (SHIFT wraps them transparently) ----------
    ctx_a, ctx_b = lib_a.open_device("mlx5_0"), lib_b.open_device("mlx5_0")
    pd_a, pd_b = lib_a.alloc_pd(ctx_a), lib_b.alloc_pd(ctx_b)
    buf_a, buf_b = (np.zeros(1 << 20, dtype=np.uint8) for _ in range(2))
    mr_a, mr_b = lib_a.reg_mr(pd_a, buf_a), lib_b.reg_mr(pd_b, buf_b)
    cq_a, cq_b = lib_a.create_cq(ctx_a, 4096), lib_b.create_cq(ctx_b, 4096)
    qp_a = lib_a.create_qp(pd_a, V.QPInitAttr(send_cq=cq_a, recv_cq=cq_a))
    qp_b = lib_b.create_qp(pd_b, V.QPInitAttr(send_cq=cq_b, recv_cq=cq_b))
    lib_a.connect(qp_a, *lib_b.route_of(qp_b))
    lib_b.connect(qp_b, *lib_a.route_of(qp_a))
    lib_a.settle(0.05)  # background shadow verbs set up the backup path

    # --- stream 32 Simple-protocol messages; kill the NIC mid-stream -------
    N, SZ = 32, 65536
    for seq in range(N):
        if seq == 10:
            print(">>> killing host0/mlx5_0 (the default NIC) ...")
            cluster.fail_nic("host0/mlx5_0")
        buf_a[:SZ] = seq + 1
        lib_b.post_recv(qp_b, V.RecvWR(wr_id=seq))
        lib_a.post_send(qp_a, V.SendWR(                   # bulk data
            wr_id=seq, opcode=V.Opcode.WRITE,
            sge=V.SGE(mr_a.addr, SZ, mr_a.lkey),
            remote_addr=mr_b.addr, rkey=mr_b.rkey, send_flags=0))
        lib_a.post_send(qp_a, V.SendWR(                   # notification
            wr_id=seq, opcode=V.Opcode.WRITE_IMM, sge=None, remote_addr=0,
            rkey=mr_b.rkey, imm_data=seq,
            send_flags=V.SEND_FLAG_SIGNALED))
        cluster.sim.run(until=cluster.sim.now + 2e-3)

    cluster.sim.run(until=cluster.sim.now + 0.5)
    imms = [wc.imm_data for wc in lib_b.poll_cq(cq_b, 1024)
            if wc.opcode is V.WCOpcode.RECV_RDMA_WITH_IMM
            and not wc.is_error]
    print(f"notifications received (exactly-once, in order): {imms}")
    if imms != list(range(N)):
        raise RuntimeError(f"notifications lost, repeated or out of order: "
                           f"{imms}")
    print(f"fallbacks: {lib_a.stats.fallbacks + lib_b.stats.fallbacks}, "
          f"resubmitted sends: {lib_a.stats.resubmitted_sends}, "
          f"fallback latency: "
          f"{[f'{t*1e3:.2f}ms' for t in lib_a.stats.fallback_latencies]}")
    print("training-style traffic survived a fatal NIC failure. \\o/")


if __name__ == "__main__":
    main()
