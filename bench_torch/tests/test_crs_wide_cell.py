"""The double-precision CRS cell at HPCG's size (``hpcg27-440-crs-f64.cg``),
its reader ``crs_spmv_roofline.wide`` and the accepted readers it shares
with ``hpcg27-200-crs.cg``: the reader's bytes against the configuration's
matrix, the reader on synthetic traces, ``crs_spmv_host_us.crs`` on spans
the port records here with int64 row pointers, and the cell on the CPU at
a small grid with the wide layout forced, correct and its control not."""

from types import SimpleNamespace as NS

import pytest
import torch

import run
from harness import spans as sp
from harness.roofline import least_s
from harness.spec import Spec
from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats import crs as crs_mod
from sparsebench_tpu_torch.formats.crs import CRSMatrix
from sparsebench_tpu_torch.host import generate_stencil
from sparsebench_tpu_torch.solvers.cg import cg_loop

CELL = "hpcg27-440-crs-f64.cg"
CONFIG = "hpcg27-440-crs-f64"
H100 = "NVIDIA H100 80GB HBM3"
SMALL = {"nx": 20, "ny": 19, "nz": 18, "itermax": 60}
METRICS = ("crs_spmv_roofline.wide", "crs_spmv_host_us.crs",
           "vector_us_per_iter.crs")
# the accepted readers of the CG loop, the device, the build and the
# kernel libraries, which read this cell as they read hpcg27-200-crs.cg
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


def test_the_spec_finds_the_cell_and_its_files(spec):
    cell = spec.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "cg",
                                                                1)
    cfg = spec.config(CONFIG)
    assert (cfg["format"], cfg["values"], cfg["indices"], cfg["row_pointers"],
            cfg["vectors"]) == ("crs", "f64", "i32", "i64", "f64")
    assert (cfg["nx"], cfg["ny"], cfg["nz"]) == (440, 440, 440)
    limits = spec.limits(CELL)
    assert set(limits) == {"x_err", "hist_err", "iters"}
    assert limits["iters"]["limit"] == 0
    assert callable(spec.reader("crs_spmv_roofline.wide").read)
    assert callable(spec.reader("vector_us_per_iter.crs").read)
    assert {m["name"] for m in spec.end_to_end(CELL)} == {
        "setup_s", "solve_ms", "solve_p95_ms"}
    assert {m["name"] for m in spec.per_layer(CELL)} == {*METRICS, *SHARED}
    # the readers that name K1, and K14's narrow form, are not this cell's
    names = {m["name"] for m in spec.per_layer(CELL)}
    assert not names & {"vector_us_per_iter.cg", "dia_spmv_roofline.cg",
                        "crs_spmv_roofline.crs"}


def test_roofline_bytes_at_440_cubed(spec):
    cfg = spec.config(CONFIG)
    wide = spec.reader("crs_spmv_roofline.wide")
    flops = wide.CRS.flops(cfg)
    assert wide.CRS.nnz(cfg) == 1318 ** 3 == 2_289_529_432
    assert wide.nbytes(cfg) == 29_518_769_192
    assert flops == 2 * 2_289_529_432
    ms = least_s(H100, wide.nbytes(cfg), flops) * 1e3
    assert ms == pytest.approx(8.811573, abs=1e-6)
    # the operations never bind, at the f32 rate nor at half of it
    assert flops / 33.5e12 * 1e3 < 0.15 < ms
    # with row pointers at the columns' width, the narrow form's count
    narrow = dict(cfg, row_pointers=cfg["indices"])
    assert wide.nbytes(narrow) == wide.CRS.nbytes(narrow)


@pytest.mark.parametrize("dims", [(5, 4, 3), (1, 5, 6), (2, 2, 2),
                                  (7, 3, 1)])
@pytest.mark.parametrize("points", [27, 7])
def test_roofline_nnz_is_the_generators(spec, dims, points):
    wide = spec.reader("crs_spmv_roofline.wide")
    cfg = dict(zip(("nx", "ny", "nz"), dims), stencil_points=points)
    assert wide.CRS.nnz(cfg) == generate_stencil(
        *dims, use_7pt=points == 7).nnz


class Ctx:
    device_kind = H100

    def __init__(self, config, found):
        self.config, self.found = config, found

    def kernel(self, names):
        return self.found.get(names, (0, 0.0))


def test_roofline_share_of_the_wide_calls(spec):
    cfg = spec.config(CONFIG)
    least = 29_518_769_192 / 3.35e12
    # 150 calls at twice the least time each
    ctx = Ctx(cfg, {("crs_spmv_wide_kernel",): (150, 150 * 2 * least)})
    assert read("crs_spmv_roofline.wide", ctx) == pytest.approx(50.0)
    # a trace without the wide form (a port without it, or the narrow
    # form's launches alone) reads nothing
    assert read("crs_spmv_roofline.wide", Ctx(cfg, {})) is None
    narrow = Ctx(cfg, {("crs_spmv_kernel",): (150, 150 * 2 * least)})
    assert read("crs_spmv_roofline.wide", narrow) is None
    other = Ctx(cfg, {("crs_spmv_wide_kernel",): (150, 1.0)})
    other.device_kind = "a card without peaks"
    assert read("crs_spmv_roofline.wide", other) is None


def test_vector_time_outside_either_form_of_k14(spec):
    """Device time per iteration outside K14's launches, of either form:
    K15's body and the loop's other operations; nothing without K14."""
    cfg = spec.config(CONFIG)
    found = {"crs_spmv_wide_kernel": (150, 1.5), "crs_spmv_kernel": (0, 0.0)}

    def kernel(names):
        return (sum(found.get(n, (0, 0.0))[0] for n in names),
                sum(found.get(n, (0, 0.0))[1] for n in names))

    ctx = NS(config=cfg, kernel=kernel, device_s=1.95, iterations=150)
    assert read("vector_us_per_iter.crs", ctx) == pytest.approx(3000.0)
    found.update(crs_spmv_wide_kernel=(0, 0.0), crs_spmv_kernel=(150, 1.5))
    assert read("vector_us_per_iter.crs", ctx) == pytest.approx(3000.0)
    found.update(crs_spmv_kernel=(0, 0.0))
    assert read("vector_us_per_iter.crs", ctx) is None
    ctx.iterations = 0
    assert read("vector_us_per_iter.crs", ctx) is None

def test_the_cell_reads_crs_host_us_on_wide_spans(recorder, monkeypatch):
    """Two CPU solves on a wide CRS matrix, recorded; the wide form's
    device operations put at each SpMV span's end, as a launch would
    start them."""
    monkeypatch.setattr(crs_mod, "NARROW_ENTRIES", 0)
    A, _ = CRSMatrix.from_stencil(8, 7, 6, device="cpu",
                                  policy=DTypePolicy.from_names("f64"))
    assert A.row_ptr.dtype == torch.int64
    b = torch.ones(A.nr, dtype=torch.float64)
    recorder.set_mode("on")
    for _ in range(2):
        cg_loop(A, b, torch.zeros_like(b), 5, 0.0)
    recorder.set_mode("auto")
    spans = recorder.spans()
    calls = [s for s in spans if s.name == "crs.spmv"]
    assert len(calls) == 2 * 5
    assert {s.attrs["row_ptr"] for s in calls} == {"i64"}
    device = [("crs_spmv_wide_kernel", s.end_ns, s.end_ns + 1000)
              for s in calls]
    end = max(s.end_ns for s in spans)
    device.append(("Memcpy DtoH", end + 500, end + 1000))
    ctx = NS(device=device, window_s=(end + 1000 - spans[0].start_ns) * 1e-9,
             device_events=len(device), config={"itermax": 5},
             iterations=2 * 5,
             busy_s=sum(e - s for _n, s, e in device) * 1e-9)
    monkeypatch.setattr(sp, "program_spans", recorder.spans)
    assert read("crs_spmv_host_us.crs", ctx) == pytest.approx(
        sum(s.end_ns - s.start_ns for s in calls) * 1e-3 / len(calls))
    assert read("launches_per_iter.cg", ctx) == pytest.approx(11 / 10)
    assert 0 < read("idle_pct.cg", ctx) < 100


def cpu_run(spec, control=False):
    cfg = dict(spec.config(CONFIG), **SMALL)
    return run.run(spec, CELL, 2**31 + 71, 0.3, False, torch.device("cpu"),
                   control=control, config=cfg)


def test_untraced_cpu_run_is_correct_on_the_wide_matrix(spec, monkeypatch):
    monkeypatch.setattr(crs_mod, "NARROW_ENTRIES", 0)
    ptrs = []
    spmv = CRSMatrix.spmv
    monkeypatch.setattr(CRSMatrix, "spmv", lambda self, x: ptrs.append(
        self.row_ptr.dtype) or spmv(self, x))
    r = cpu_run(spec)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["metrics"] == {} and r["device"] == {}
    assert len(ptrs) >= SMALL["itermax"] * (r["attempted"] + 2)
    assert set(ptrs) == {torch.int64}


def test_control_is_not_correct(spec, monkeypatch):
    monkeypatch.setattr(crs_mod, "NARROW_ENTRIES", 0)
    r = cpu_run(spec, control=True)
    assert not r["correct"], r["checks"]
