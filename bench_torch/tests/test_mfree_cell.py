"""The matrix-free cell (``hpcg27-200-mfree.vmem``), its two readers and
the accepted ``.cg`` readers it shares: the bytes and operations of
``stencil_cg_roofline.vmem`` from the configuration, the readers on
synthetic traces and on spans the port records here, and the cell on the
CPU at a small grid, correct, and its control and each planted fault
not."""

from types import SimpleNamespace as NS

import pytest
import torch

import run
from harness import spans as sp
from harness.roofline import least_s
from harness.spec import Spec
from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.stencil import StencilOperator
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.solvers import cg as cg_mod
from sparsebench_tpu_torch.solvers.cg import cg_vmem_loop
from test_run import FAULTS, plant

CELL = "hpcg27-200-mfree.vmem"
CONFIG = "hpcg27-200-mfree"
H100 = "NVIDIA H100 80GB HBM3"
SMALL = {"nx": 20, "ny": 19, "nz": 18, "itermax": 60}
METRICS = ("stencil_cg_roofline.vmem", "stencil_cg_host_us.vmem")
# the accepted readers of the CG loop, the device, the build and the
# kernel libraries, which read this cell as they read hpcg27-200.cg
SHARED = ("matrix_build_s", "launches_per_iter.cg", "idle_pct.cg",
          "loop_host_us_per_iter.cg", "loop_idle_pct.cg", "kernel_load_s")


@pytest.fixture(scope="module")
def spec():
    return Spec()


def read(metric, ctx):
    return Spec().reader(metric).read(ctx)


@pytest.fixture
def recorder():
    profiler.RECORDER.clear()
    yield profiler
    profiler.set_mode("auto")
    profiler.RECORDER.clear()


def test_the_cell_reports_its_metrics(spec):
    cell = spec.cell(CELL)
    assert cell["config"] == CONFIG and cell["chips"] == 1
    assert spec.traffic(cell["traffic"])["variant"] == "vmem"
    cfg = spec.config(CONFIG)
    assert (cfg["format"], cfg["operator"], cfg["vectors"]) == (
        "stencil", "matrix-free", "f32")
    assert {m["name"] for m in spec.end_to_end(CELL)} == {
        "setup_s", "solve_ms", "solve_p95_ms"}
    assert {m["name"] for m in spec.per_layer(CELL)} == {*METRICS, *SHARED}
    # K5 is no vector work of a body: that reader is not this cell's
    assert "vector_us_per_iter.cg" not in {
        m["name"] for m in spec.per_layer(CELL)}


def test_roofline_bytes_at_200_cubed(spec):
    cfg = spec.config(CONFIG)
    k5 = spec.reader("stencil_cg_roofline.vmem")
    v = 8_000_000 * 4
    assert k5.nbytes(cfg) == 3 * v + 149 * 2 * (3 * v - 52_428_800) \
        == 13_080_217_600
    assert k5.flops(cfg) == (2 + 149 * 38) * 8_000_000
    ms = least_s(H100, k5.nbytes(cfg), k5.flops(cfg)) * 1e3
    assert ms == pytest.approx(3.904543, abs=1e-6)


def test_roofline_within_the_l2_counts_the_vectors_once(spec):
    """At 100^3 r, p and x (12 MB) fit the L2: 3 vectors, no iteration's
    traffic; 7-point applies count 8 operations a point."""
    k5 = spec.reader("stencil_cg_roofline.vmem")
    cfg = dict(spec.config(CONFIG), nx=100, ny=100, nz=100)
    assert k5.nbytes(cfg) == 3 * 4_000_000
    assert k5.flops(dict(cfg, stencil_points=7)) == (2 + 149 * 18) * 10**6


class Ctx:
    device_kind = H100

    def __init__(self, config, found):
        self.config, self.found = config, found

    def kernel(self, names):
        return self.found.get(names, (0, 0.0))


def test_roofline_share_of_k5_calls(spec):
    cfg = spec.config(CONFIG)
    least = 13_080_217_600 / 3.35e12
    # 40 solves at five times the least time each
    ctx = Ctx(cfg, {("stencil_cg_vmem_kernel",): (40, 40 * 5 * least)})
    assert read("stencil_cg_roofline.vmem", ctx) == pytest.approx(20.0)
    # a trace without K5 reads nothing
    assert read("stencil_cg_roofline.vmem", Ctx(cfg, {})) is None
    other = Ctx(cfg, {("stencil_cg_vmem_kernel",): (40, 1.0)})
    other.device_kind = "a card without peaks"
    assert read("stencil_cg_roofline.vmem", other) is None


def context(device, window_ns):
    return NS(device=[("op", a, b) for a, b in device],
              window_s=window_ns * 1e-9,
              device_events=len(device),
              busy_s=sum(b - a for a, b in device) * 1e-9)


def test_host_us_on_synthetic_spans(monkeypatch):
    spans = [NS(name="stencil.cg_vmem", start_ns=a, end_ns=a + 40)
             for a in (100, 300, 500)]
    spans.append(NS(name="cg.solve", start_ns=90, end_ns=700))
    ctx = context([(50, 60), (950, 1000)], 1000)
    monkeypatch.setattr(sp, "program_spans", lambda: spans)
    assert read("stencil_cg_host_us.vmem", ctx) == pytest.approx(40e-3)
    # spans outside the window are not counted; none left, nothing read
    assert read("stencil_cg_host_us.vmem",
                context([(50, 60), (950, 1000)], 400)) is None
    # a port that records its solves but no K5 span (as before the span)
    monkeypatch.setattr(sp, "program_spans", lambda: spans[3:])
    assert read("stencil_cg_host_us.vmem", ctx) is None
    monkeypatch.setattr(sp, "program_spans", lambda: None)
    assert read("stencil_cg_host_us.vmem", ctx) is None


def test_readers_on_spans_the_port_records(recorder, monkeypatch):
    """Two CPU solves of the matrix-free loop, recorded; K2's and K5's
    device operations put at the ends of their spans, as launches would
    start them, and each solve closed by its check's copy to the host."""
    A, _ = StencilOperator.from_stencil(8, 7, 6, device="cpu",
                                        policy=DTypePolicy.from_names("f32"))
    b = torch.ones(A.nr)
    recorder.set_mode("on")
    for _ in range(2):
        cg_vmem_loop(A, b, torch.zeros_like(b), 5, 0.0)
    recorder.set_mode("auto")
    spans = recorder.spans()
    k5 = [s for s in spans if s.name == "stencil.cg_vmem"]
    applies = [s for s in spans if s.name == "stencil.apply"]
    solves = [s for s in spans if s.name == "cg.solve"]
    assert len(k5) == len(applies) == len(solves) == 2
    # K5 runs on past its solve's span, which returns on the launch
    device = sorted(
        [("stencil_apply_kernel", s.end_ns, s.end_ns + 100)
         for s in applies]
        + [("stencil_cg_vmem_kernel", s.end_ns, t.end_ns + 5000)
           for s, t in zip(k5, solves)]
        + [("Memcpy DtoH", t.end_ns + 5000, t.end_ns + 5100)
           for t in solves], key=lambda d: d[1])
    end = device[-1][2]
    # the window opens a microsecond before the first solve
    ctx = NS(device=device, window_s=(end - spans[0].start_ns + 1000) * 1e-9,
             device_events=len(device), config={"itermax": 5},
             iterations=2 * 5, spans={"matrix_build": 0.25},
             busy_s=sum(e - s for _n, s, e in device) * 1e-9)
    monkeypatch.setattr(sp, "program_spans", recorder.spans)
    assert read("stencil_cg_host_us.vmem", ctx) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in k5) * 1e-3 / 2)
    # the shared readers read the matrix-free solves
    assert read("matrix_build_s", ctx) == 0.25
    assert read("launches_per_iter.cg", ctx) == pytest.approx(6 / 10)
    assert 0 < read("idle_pct.cg", ctx) < 100
    assert read("loop_host_us_per_iter.cg", ctx) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in solves) * 1e-3 / (2 * 5))
    assert 0 <= read("loop_idle_pct.cg", ctx) < 100
    monkeypatch.setattr(_build, "LOADS", [
        _build.Load("stencil", True, 1.5),
        _build.Load("stencil_cg_vmem", False, 0.25)])
    assert read("kernel_load_s", ctx) == pytest.approx(1.75)


def cpu_run(spec, control=False):
    cfg = dict(spec.config(CONFIG), **SMALL)
    return run.run(spec, CELL, 2**31 + 41, 0.3, False, torch.device("cpu"),
                   control=control, config=cfg)


def test_untraced_cpu_run_is_correct_through_the_vmem_loop(spec,
                                                          monkeypatch):
    calls = []
    whole = cg_mod.stencil_cg_vmem_torch
    monkeypatch.setattr(cg_mod, "stencil_cg_vmem_torch",
                        lambda *a: calls.append(1) or whole(*a))
    r = cpu_run(spec)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"] == {} and r["device"] == {}
    # the warm-up's and the window's solves, each one whole-solve call
    assert len(calls) == r["attempted"] + 2


def test_control_is_not_correct(spec):
    r = cpu_run(spec, control=True)
    assert not r["correct"], r["checks"]
    assert r["checks"]["x_err"]["value"] > r["checks"]["x_err"]["limit"]


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not_correct(spec, monkeypatch, fault):
    plant(monkeypatch, spec.traffic(spec.cell(CELL)["traffic"]), fault)
    r = cpu_run(spec)
    assert not r["correct"], (fault, r["checks"])
