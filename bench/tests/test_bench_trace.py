"""The reduction of a profiler trace: busy time as the union of device
intervals inside the window, time by kernel, the kernels launched inside
a bench range, and the idle gaps named by what the host was doing."""

import pytest
import torch
from torch.autograd import DeviceType

from bench import trace


class Ev:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, kind, name, start, end, thread=1, corr=0, linked=0):
        self.kind, self.n, self.s, self.e = kind, name, start, end
        self.thread, self.corr, self.linked = thread, corr, linked

    def device_type(self):
        return getattr(DeviceType, self.kind)

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.e - self.s

    def start_thread_id(self):
        return self.thread

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def is_user_annotation(self):
        return self.n.startswith("bench.")


MS = 1_000_000
EVENTS = [
    Ev("CPU", "bench.window", 0, 100 * MS),
    Ev("CUDA", "bench.window", 0, 100 * MS),          # its device shadow
    Ev("CPU", "bench.B2", 10 * MS, 30 * MS, corr=5),
    Ev("CPU", "aten::mul", 11 * MS, 12 * MS, corr=6),
    Ev("CPU", "aten::copy_", 60 * MS, 61 * MS, corr=7),
    Ev("CUDA", "dq_kernel", 12 * MS, 22 * MS, linked=5),
    Ev("CUDA", "elementwise_kernel", 20 * MS, 25 * MS, linked=6),
    Ev("CUDA", "gemm", 40 * MS, 60 * MS, linked=0),
    Ev("CUDA", "gemm", 95 * MS, 110 * MS, linked=7),  # clipped at 100
]


def test_busy_time_is_the_union_inside_the_window():
    st = trace.reduce(EVENTS)
    assert st.window_s == pytest.approx(0.1)
    # [12, 25] + [40, 60] + [95, 100]
    assert st.busy_s == pytest.approx(0.038)
    assert st.kernel_s["gemm"] == pytest.approx(0.025)
    assert st.matching(r"dq_kernel|elementwise") == pytest.approx(0.015)


def test_kernels_launched_in_a_bench_range():
    st = trace.reduce(EVENTS)
    assert st.in_range("bench.B2") == pytest.approx(0.015)
    assert st.in_range("bench.B2", but=r"dq_kernel") == pytest.approx(0.005)
    assert st.in_range("bench.nothing") == 0.0


def test_idle_gaps_longest_first_with_the_host_at_them():
    st = trace.reduce(EVENTS)
    lengths = [g for _, g in st.idle_gaps]
    assert lengths == pytest.approx([0.035, 0.015, 0.012])
    names = [n for n, _ in st.idle_gaps]
    assert names[0] == "aten::copy_"          # 60 ms: the copy starts
    assert names[2] == "host idle"     # 0 ms: nothing open but the window
    assert st.top_ops[0] == ("gemm", pytest.approx(0.025))


def test_a_trace_of_the_cpu_reduces():
    tracer = trace.Tracer(True)
    tracer.start()
    with tracer.window():
        torch.randn(64, 64) @ torch.randn(64, 64)
    tracer.stop()
    assert tracer.stats.window_s > 0 and tracer.stats.busy_s == 0.0


@pytest.mark.parametrize("name,want", [
    ("void at::native::(anonymous namespace)::k<4>(int, float*)",
     "at::native::(anonymous namespace)::k<4>"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN",
     "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN"),
    ("void hopper::decode_kernel<128>(hopper::Params, int)",
     "hopper::decode_kernel<128>"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH"),
])
def test_short_kernel_names(name, want):
    assert trace.short(name) == want
