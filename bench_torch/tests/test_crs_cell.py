"""The CRS cell (``hpcg27-200-crs.cg``), its two readers and the accepted
``.cg`` readers it shares: the byte count of ``crs_spmv_roofline.crs``
against the configuration's matrix, the readers on synthetic traces and on
spans the port records here, and the cell on the CPU at a small grid,
correct and its control not."""

from types import SimpleNamespace as NS

import pytest
import torch

import run
from harness import spans as sp
from harness.roofline import least_s
from harness.spec import Spec
from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.crs import CRSMatrix
from sparsebench_tpu_torch.host import generate_stencil
from sparsebench_tpu_torch.solvers.cg import cg_loop

CELL = "hpcg27-200-crs.cg"
H100 = "NVIDIA H100 80GB HBM3"
SMALL = {"nx": 20, "ny": 19, "nz": 18, "itermax": 60}
METRICS = ("crs_spmv_roofline.crs", "crs_spmv_host_us.crs")
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
    assert cell["config"] == "hpcg27-200-crs" and cell["chips"] == 1
    cfg = spec.config("hpcg27-200-crs")
    assert (cfg["format"], cfg["values"], cfg["indices"], cfg["vectors"]) == (
        "crs", "f32", "i32", "f32")
    assert {m["name"] for m in spec.end_to_end(CELL)} == {
        "setup_s", "solve_ms", "solve_p95_ms"}
    assert {m["name"] for m in spec.per_layer(CELL)} == {*METRICS, *SHARED}


def test_roofline_bytes_at_200_cubed(spec):
    cfg = spec.config("hpcg27-200-crs")
    k14 = spec.reader("crs_spmv_roofline.crs")
    assert k14.nnz(cfg) == 598 ** 3 == 213_847_192
    assert k14.nbytes(cfg) == 1_806_777_540
    assert k14.flops(cfg) == 2 * 213_847_192
    ms = least_s(H100, k14.nbytes(cfg), k14.flops(cfg)) * 1e3
    assert ms == pytest.approx(0.5393366, abs=1e-7)


@pytest.mark.parametrize("dims", [(5, 4, 3), (1, 5, 6), (2, 2, 2),
                                  (7, 3, 1)])
@pytest.mark.parametrize("points", [27, 7])
def test_roofline_nnz_is_the_generators(spec, dims, points):
    k14 = spec.reader("crs_spmv_roofline.crs")
    cfg = dict(zip(("nx", "ny", "nz"), dims), stencil_points=points)
    assert k14.nnz(cfg) == generate_stencil(
        *dims, use_7pt=points == 7).nnz


class Ctx:
    device_kind = H100

    def __init__(self, config, found):
        self.config, self.found = config, found

    def kernel(self, names):
        return self.found.get(names, (0, 0.0))


def test_roofline_share_of_k14_calls(spec):
    cfg = spec.config("hpcg27-200-crs")
    least = 1_806_777_540 / 3.35e12
    # 150 calls at twice the least time each
    ctx = Ctx(cfg, {("crs_spmv_kernel",): (150, 150 * 2 * least)})
    assert read("crs_spmv_roofline.crs", ctx) == pytest.approx(50.0)
    # a trace without K14 (a port without it) reads nothing
    assert read("crs_spmv_roofline.crs", Ctx(cfg, {})) is None


def context(device, window_ns):
    return NS(device=[("op", a, b) for a, b in device],
              window_s=window_ns * 1e-9,
              device_events=len(device),
              busy_s=sum(b - a for a, b in device) * 1e-9)


def test_idle_share_on_a_synthetic_window():
    ctx = context([(100, 200), (400, 500), (900, 1000)], 1000)
    assert read("idle_pct.cg", ctx) == pytest.approx(70.0)
    assert read("idle_pct.cg", context([], 1000)) is None


def test_host_us_on_synthetic_spans(monkeypatch):
    spans = [NS(name="crs.spmv", start_ns=a, end_ns=a + 30)
             for a in (100, 300, 500)]
    spans.append(NS(name="dia.spmv", start_ns=600, end_ns=700))
    ctx = context([(50, 60), (950, 1000)], 1000)
    monkeypatch.setattr(sp, "program_spans", lambda: spans)
    assert read("crs_spmv_host_us.crs", ctx) == pytest.approx(30e-3)
    # spans outside the window are not counted; none left, nothing read
    assert read("crs_spmv_host_us.crs", context([(50, 60), (950, 1000)],
                                                400)) is None
    monkeypatch.setattr(sp, "program_spans", lambda: None)
    assert read("crs_spmv_host_us.crs", ctx) is None


def test_readers_on_spans_the_port_records(recorder, monkeypatch):
    """Two CPU solves on the port's CRS matrix, recorded; K14's device
    operations put at each SpMV span's end, as a launch would start them."""
    A, _ = CRSMatrix.from_stencil(8, 7, 6, device="cpu",
                                  policy=DTypePolicy.from_names("f32"))
    b = torch.ones(A.nr)
    recorder.set_mode("on")
    for _ in range(2):
        cg_loop(A, b, torch.zeros_like(b), 5, 0.0)
    recorder.set_mode("auto")
    spans = [s for s in recorder.spans() if not s.name.startswith(
        "crs.build")]
    calls = [s for s in spans if s.name == "crs.spmv"]
    assert len(calls) == 2 * 5
    assert {s.attrs["kernel"] for s in calls} == {"torch"}
    device = [("crs_spmv_kernel", s.end_ns, s.end_ns + 1000) for s in calls]
    end = max(s.end_ns for s in spans)
    device.append(("Memcpy DtoH", end + 500, end + 1000))
    ctx = NS(device=device, window_s=(end + 1000 - spans[0].start_ns) * 1e-9,
             device_events=len(device),
             busy_s=sum(e - s for _n, s, e in device) * 1e-9)
    monkeypatch.setattr(sp, "program_spans", recorder.spans)
    assert read("crs_spmv_host_us.crs", ctx) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in calls) * 1e-3 / len(calls))
    assert 0 < read("idle_pct.cg", ctx) < 100
    # the loop's readers see the CRS solves' own spans
    ctx.config = {"itermax": 5}
    solves = [s for s in spans if s.name == "cg.solve"]
    assert len(solves) == 2
    assert read("loop_host_us_per_iter.cg", ctx) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in solves) * 1e-3 / (2 * 5))
    assert 0 <= read("loop_idle_pct.cg", ctx) < 100


def cpu_run(control=False):
    spec = Spec()
    cfg = dict(spec.config("hpcg27-200-crs"), **SMALL)
    return run.run(spec, CELL, 2**31 + 29, 0.3, False, torch.device("cpu"),
                   control=control, config=cfg)


def test_untraced_cpu_run_is_correct_on_the_crs_matrix(monkeypatch):
    calls = []
    spmv = CRSMatrix.spmv
    monkeypatch.setattr(CRSMatrix, "spmv",
                        lambda self, x: calls.append(1) or spmv(self, x))
    r = cpu_run()
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"] == {} and r["device"] == {}
    # the inputs' products are the reference's; every SpMV is the matrix's
    assert len(calls) >= SMALL["itermax"] * (r["attempted"] + 2)


def test_control_is_not_correct():
    r = cpu_run(control=True)
    assert not r["correct"], r["checks"]
