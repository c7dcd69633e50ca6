"""The port's spans read beside the device trace (``harness/spans.py``),
the readers of the metrics built on them, on synthetic intervals and on
spans the port records here on the CPU, and the untraced run they leave
as it was."""

from types import SimpleNamespace as NS

import pytest
import torch

import program_trace
import run
from harness import spans as sp
from harness.spec import Spec
from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.solvers.cg import cg_loop

OUT = sp.OUTSIDE
CELLS = [w["name"] for w in Spec().bench["workloads"]]
NEW_METRICS = ("loop_host_us_per_iter.cg", "loop_idle_pct.cg",
               "spmv_host_us.spmv", "kernel_load_s")


def S(name, a, b):
    return NS(name=name, start_ns=a, end_ns=b)


def context(device, window_ns, itermax=3):
    """A traced window's context as the readers see it: device operations
    (start, end) in ns, the window ending with the last."""
    return NS(device=[("op", a, b) for a, b in device],
              window_s=window_ns * 1e-9, config={"itermax": itermax})


def read(metric, ctx):
    return Spec().reader(metric).read(ctx)


@pytest.fixture
def recorder():
    profiler.RECORDER.clear()
    yield profiler
    profiler.set_mode("auto")
    profiler.RECORDER.clear()


# device busy [100, 200], [400, 500], [900, 1000]; spans A [50, 700] with
# children B [150, 300] and C [450, 650], D [800, 850]
DEVICE = [(100, 200), (400, 500), (900, 1000)]
SPANS = [S("A", 50, 700), S("B", 150, 300), S("C", 450, 650),
         S("D", 800, 850)]


def test_idle_is_put_down_to_the_innermost_open_span():
    b = sp.breakdown(context(DEVICE, 1000), SPANS)
    ns = {k: round(v * 1e9) for k, v in b["idle_by_span"].items()}
    # the gap [0, 100] straddles the outside and A; [200, 400] B then A;
    # [500, 900] C, A, the outside, D and the outside again
    assert ns == {OUT: 200, "A": 200, "B": 100, "C": 150, "D": 50}
    assert round(b["idle_s"] * 1e9) == 700 == sum(ns.values())
    assert round(b["window_s"] * 1e9) == 1000


def test_self_time_is_the_span_less_its_children():
    b = sp.breakdown(context(DEVICE, 1000), SPANS)
    ns = {k: round(v * 1e9) for k, v in b["self_s"].items()}
    assert ns == {OUT: 300, "A": 300, "B": 150, "C": 200, "D": 50}
    assert sum(ns.values()) == 1000


def test_spans_beyond_the_window_are_cut_to_it():
    # the window is the last 600 ns: [400, 1000]
    b = sp.breakdown(context(DEVICE, 600), SPANS)
    ns = {k: round(v * 1e9) for k, v in b["idle_by_span"].items()}
    assert ns == {"C": 150, "A": 50, OUT: 150, "D": 50}
    assert sum(ns.values()) == round(b["idle_s"] * 1e9) == 400
    assert sp.in_window(SPANS, 400, 1000, "A") == []
    assert sp.in_window(SPANS, 400, 1000, "C") == [SPANS[2]]


def test_idle_intervals_of_overlapping_operations():
    dev = [("a", 0, 50), ("b", 10, 30), ("c", 40, 70), ("d", 90, 95)]
    assert sp.idle_intervals(dev, 0, 100) == [(70, 90), (95, 100)]
    assert sp.idle_intervals(dev, 20, 92) == [(70, 90)]
    assert sp.idle_intervals([], 0, 10) == [(0, 10)]


def loop_spans(solve_starts, bodies=2, spmv=True):
    """The spans of CG solves as the port nests them: a solve holds its
    init and its bodies, each with an SpMV inside."""
    out = []
    for t in solve_starts:
        out.append(S("cg.solve", t, t + 100 * (bodies + 1)))
        for j in range(bodies + 1):
            a = t + 100 * j
            out.append(S("cg.init" if j == 0 else "cg.body", a, a + 100))
            if spmv:
                out.append(S("dia.spmv", a + 20, a + 40))
    return out


def test_loop_readers_on_a_synthetic_window(monkeypatch):
    # two solves of 300 ns, [0, 300] and [400, 700]; the device busy from
    # 40 to 100 of every 100 of a solve, so idle 0-40 (the loop, then the
    # SpMV from 20) each 100; [300, 400] and [700, 800] idle outside
    spans = loop_spans([0, 400])
    device = [(t + j * 100 + 40, t + j * 100 + 100)
              for t in (0, 400) for j in range(3)] + [(799, 800)]
    ctx = context(device, 800)
    monkeypatch.setattr(sp, "program_spans", lambda: spans)
    assert read("loop_host_us_per_iter.cg", ctx) == pytest.approx(
        600e-3 / (2 * 3))
    # loop-owned idle: 20 ns of each of 6 hundreds, of a window of 800
    assert read("loop_idle_pct.cg", ctx) == pytest.approx(100 * 120 / 800)
    assert read("spmv_host_us.spmv", ctx) == pytest.approx(20e-3)
    b = sp.breakdown(ctx, spans)
    assert round(b["idle_by_span"]["dia.spmv"] * 1e9) == 120
    assert round(b["idle_by_span"][OUT] * 1e9) == 199
    assert sum(b["idle_by_span"].values()) == pytest.approx(b["idle_s"])


def test_readers_give_nothing_without_the_recorder(monkeypatch):
    """The parent of the recorder: its port has no spans and no loads."""
    ctx = context(DEVICE, 1000)
    monkeypatch.setattr(sp, "program_spans", lambda: None)
    monkeypatch.delattr(_build, "LOADS")
    for metric in NEW_METRICS:
        assert read(metric, ctx) is None
    # a recorder with no span of the metric's layer in the window
    monkeypatch.setattr(sp, "program_spans", lambda: SPANS)
    for metric in NEW_METRICS[:3]:
        assert read(metric, ctx) is None


def test_kernel_load_s_sums_the_loads(monkeypatch):
    monkeypatch.setattr(_build, "LOADS", [_build.Load("dia_spmv", True, 2.5),
                                          _build.Load("dia_spmm", False, 0.25)])
    assert read("kernel_load_s", None) == 2.75
    monkeypatch.setattr(_build, "LOADS", [])
    assert read("kernel_load_s", None) is None


def test_readers_on_spans_the_port_records(recorder, monkeypatch):
    """A CPU solve recorded by the port; device operations put at each SpMV
    span's end, as the kernel would start after its launch, and after the
    last solve, as its check's copy to the host closes the window."""
    A, _ = DiaMatrix.from_stencil(8, 7, 6, device="cpu",
                                  policy=DTypePolicy.from_names("f32"))
    b = torch.ones(A.nr)
    recorder.set_mode("on")
    for _ in range(2):
        cg_loop(A, b, torch.zeros_like(b), 5, 0.0)
    recorder.set_mode("auto")
    spans = [s for s in recorder.spans() if s.name != "dia.build"
             and not s.name.startswith("dia.build.")]
    device = [("dia_spmv_kernel", s.end_ns, s.end_ns + 1000)
              for s in spans if s.name == "dia.spmv"]
    end = max(s.end_ns for s in spans)
    device.append(("Memcpy DtoH", end + 500, end + 1000))
    w1 = end + 1000
    ctx = NS(device=device, window_s=(w1 - spans[0].start_ns) * 1e-9,
             config={"itermax": 5})
    monkeypatch.setattr(sp, "program_spans", recorder.spans)
    solves = [s for s in spans if s.name == "cg.solve"]
    assert len(solves) == 2
    host_us = sum(s.end_ns - s.start_ns for s in solves) * 1e-3 / (2 * 5)
    assert read("loop_host_us_per_iter.cg", ctx) == pytest.approx(host_us)
    assert 0 < read("loop_idle_pct.cg", ctx) < 100
    calls = [s for s in spans if s.name == "dia.spmv"]
    assert len(calls) == 2 * 5
    assert read("spmv_host_us.spmv", ctx) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in calls) * 1e-3 / len(calls))
    bd = sp.breakdown(ctx, spans)
    assert sum(bd["idle_by_span"].values()) == pytest.approx(bd["idle_s"])
    assert sum(bd["self_s"].values()) == pytest.approx(bd["window_s"])


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_keeps_its_keys_and_records_nothing(recorder, cell):
    spec = Spec()
    # test_run.py's small grid
    cfg = dict(spec.config(spec.cell(cell)["config"]), nx=20, ny=19, nz=18,
               itermax=60)
    r = run.run(spec, cell, 2**31 + 23, 0.2, False, torch.device("cpu"),
                config=cfg)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "spans", "checks"]
    assert r["correct"], r["checks"]
    assert set(r["spans"]) == {"matrix_build", "inputs", "warmup", "window"}
    # the recorder stays off without a profiler session
    assert recorder.spans() == [] and recorder.counts() == {}


def test_program_trace_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would measure")
    assert program_trace.main(["--workload", "hpcg27-200.cg",
                               "--seed", "1"]) == 2
    assert "no result" in capsys.readouterr().err
