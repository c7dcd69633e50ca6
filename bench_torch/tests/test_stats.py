"""The window's arithmetic on synthetic times, and the trace's arithmetic
on synthetic events."""

import statistics

import pytest
from torch.autograd import DeviceType

from harness.stats import percentile, spread, window_metrics
from harness.trace import Trace, short


def test_percentile_is_statistics_quantiles():
    values = [float(v) for v in range(1, 201)]
    assert percentile(values, 95) == statistics.quantiles(values, n=100)[94]
    # 190 solves of 50 ms and 10 of 80 ms: the p95 lies on the slow tail
    times = [0.05] * 190 + [0.08] * 10
    assert 0.05 < percentile(times, 95) <= 0.08
    assert percentile([0.07], 95) == 0.07


def test_window_metrics():
    m = window_metrics(10.0, 100, 8, [0.1] * 100)
    assert m["op_ms"] == pytest.approx(100.0)
    assert m["rhs_ms"] == pytest.approx(12.5)
    assert m["op_p95_ms"] == pytest.approx(100.0)
    assert "op_p95_ms" not in window_metrics(1.0, 4, 1, [])


def test_spread():
    # quartiles of 1..9 by the exclusive method: 2.5 and 7.5, median 5
    assert spread(list(range(1, 10))) == pytest.approx(1.0)
    assert spread([2.0] * 6) == 0.0


class Event:
    def __init__(self, name, start, dur, device=DeviceType.CUDA, tid=7):
        self._v = (name, start, dur, device, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]


CFG = {"itermax": 150, "nx": 2, "ny": 2, "nz": 2}
TRAFFIC = {"op": "cg", "rhs": 1}


def test_trace_busy_kernels_and_gaps():
    events = [
        # host events are no device work
        Event("aten::add", 100, 200, DeviceType.CPU),
        # overlapping kernels count once in busy time
        Event("void (anonymous namespace)::dia_spmv_kernel<float>(float*, "
              "int)", 0, 300),
        Event("at::native::add", 200, 200),
        # 200 ns idle while the host issues the next K1
        Event("void (anonymous namespace)::dia_spmv_kernel<float>(float*, "
              "int)", 600, 400),
        Event("Memcpy DtoH (Device -> Pageable)", 1000, 100),
        # 300 ns idle after the check's copy to the host
        Event("memset", 1400, 100),
    ]
    t = Trace(events, 2e-6, 1, CFG, TRAFFIC, "NVIDIA H100", {})
    assert t.device_events == 5
    assert t.busy_s == pytest.approx(1000e-9)
    assert t.device_s == pytest.approx(1100e-9)
    assert t.kernel(("dia_spmv_kernel",)) == (2, pytest.approx(700e-9))
    assert t.iterations == 150
    b = t.breakdown()
    assert b["device_ops"][0] == ["dia_spmv_kernel<float>",
                                  pytest.approx(700e-9)]
    assert dict(b["idle_gaps"]) == {
        "host issuing dia_spmv_kernel<float>": pytest.approx(200e-9),
        "host between operations (synchronise, check, next issue)":
            pytest.approx(300e-9)}


def test_short_names():
    assert short("void k<a<b>, 4>(int*, float)") == "k<a<b>, 4>"
    assert short("x" * 200) == "x" * 96
    assert short("void (anonymous namespace)::k<2>(int)") == "k<2>"
