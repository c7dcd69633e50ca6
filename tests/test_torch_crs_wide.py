"""The double-precision CRS deployment at HPCG's size (``hpcg27-440-crs-f64``,
cell ``hpcg27-440-crs-f64.cg``): 2,289,529,432 entries, so
``CRSMatrix.from_stencil`` widens the row pointers to int64 and K14 runs
its wide form (``ops/crs_spmv.py``, ``csrc/crs_spmv.cu``), without the
JAX package.

Here on the CPU, at 12 x 11 x 10 with 60 iterations and the threshold
``formats/crs.py NARROW_ENTRIES`` set below the grid's entries, so that
this grid builds the wide layout: the configuration through the
benchmark's own entries (``bench_torch/harness/program.py``
``build_matrix`` and ``cg_loop``), on seeded x* and b = A x*, within the
cell's limits (``bench_torch/limits/hpcg27-440-crs-f64.cg.json``) against
the plain f64 reference (``bench_torch/reference/hpcg.py``) and the f32
control outside them; the spans name the int64 row pointers, and the
wide form's counter stays at 0 (the plain version runs on the CPU).
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.formats import crs as crs_mod
from sparsebench_tpu_torch.ops.crs_spmv import crs_spmv

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_torch"
CELL = "hpcg27-440-crs-f64.cg"
SMALL = {"nx": 12, "ny": 11, "nz": 10, "itermax": 60}
SEEDS = [2**31 + 7, 2**31 + 61, 2**33 + 5]
CPU = torch.device("cpu")


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


hpcg = _module("bench_reference_hpcg", BENCH / "reference" / "hpcg.py")
program = _module("bench_harness_program", BENCH / "harness" / "program.py")
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
CONFIG = json.loads((BENCH / "configs" / "hpcg27-440-crs-f64.json")
                    .read_text())
HIST_FROM = json.loads((BENCH / "traffic" / "cg.json").read_text())[
    "hist_from"]


@pytest.fixture
def wide(monkeypatch):
    """The threshold below any grid's entries: every build is wide."""
    monkeypatch.setattr(crs_mod, "NARROW_ENTRIES", 0)


@pytest.fixture
def recorder():
    profiler.RECORDER.clear()
    yield profiler
    profiler.set_mode("auto")
    profiler.RECORDER.clear()


def small_cfg():
    return dict(CONFIG, **SMALL)


def solve(cfg, seed, vectors):
    """The cell's numbers of one solve through the benchmark's entries:
    the matrix of ``build_matrix`` for ``vectors``, b = A x* (x* uniform
    in [0, 1) from ``seed``, the reference's f64 product rounded once to
    ``vectors``) and ``cg_loop`` of the mix's variant from x = 0. Returns
    ({"x_err", "hist_err", "iters"}, k, the matrix)."""
    A = program.build_matrix(cfg, vectors, CPU)
    gen = torch.Generator().manual_seed(seed)
    xs = torch.rand(A.nr, generator=gen, dtype=torch.float64)
    b = hpcg.apply(xs, cfg).to(program.DTYPES[vectors])
    x, k, hist = program.cg_loop("standard")(
        A, b, torch.zeros_like(b), cfg["itermax"],
        torch.tensor(cfg["eps"], dtype=torch.float32))
    x_ref, k_ref, h_ref = hpcg.cg(b.double()[None], cfg)
    h_ref = h_ref[:, 0]
    keep = h_ref >= HIST_FROM * h_ref[0]
    gap = ((hist.double() - h_ref).abs() / h_ref)[keep]
    numbers = {
        "x_err": float((x.double() - x_ref[0]).abs().max()
                       / x_ref[0].abs().max()),
        "hist_err": float(gap.max()),
        "iters": float(abs(int(k) - int(k_ref[0]))),
    }
    return numbers, int(k), A


def test_the_configuration_is_the_double_precision_crs_build():
    assert (CONFIG["format"], CONFIG["values"], CONFIG["indices"],
            CONFIG["row_pointers"], CONFIG["vectors"],
            CONFIG["accumulation"], CONFIG["control_vectors"]) == (
        "crs", "f64", "i32", "i64", "f64", "f64", "f32")
    assert (CONFIG["nx"], CONFIG["ny"], CONFIG["nz"]) == (440, 440, 440)
    assert (CONFIG["itermax"], CONFIG["eps"]) == (150, 0.0)
    assert CONFIG["reduced"] == [] and len(CONFIG["assumed"]) == 1
    # the grid's entries pass int32 and stay within 32 bits unsigned
    nnz = (3 * 440 - 2) ** 3
    assert crs_mod.NARROW_ENTRIES < 2**31 - 1 < nnz < 2**32
    assert (3 * 430 - 2) ** 3 <= crs_mod.NARROW_ENTRIES < (3 * 431 - 2) ** 3


@pytest.mark.parametrize("seed", SEEDS)
def test_the_solve_is_within_the_cells_limits(wide, seed):
    cfg = small_cfg()
    numbers, k, A = solve(cfg, seed, "f64")
    assert A.row_ptr.dtype == torch.int64 and A.col.dtype == torch.int32
    assert A.val.dtype == torch.float64
    assert k == cfg["itermax"]
    for name, value in numbers.items():
        assert value <= LIMITS[name]["limit"], (name, value)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_outside_the_cells_limits(wide, seed):
    """f32 values and vectors on the same wide layout: at least one
    number fails its limit."""
    cfg = small_cfg()
    numbers, k, A = solve(cfg, seed, "f32")
    assert A.row_ptr.dtype == torch.int64 and A.val.dtype == torch.float32
    assert k == cfg["itermax"]
    assert any(value > LIMITS[name]["limit"]
               for name, value in numbers.items()), numbers


def test_a_solve_records_wide_row_pointers(wide, recorder):
    """The build's span and every SpMV span name the int64 row pointers;
    on the CPU no K14 launch is made, so ``crs_spmv.wide`` stays 0."""
    recorder.set_mode("on")
    launches = crs_spmv.launches
    cfg = dict(small_cfg(), nx=6, ny=5, nz=4)
    A = program.build_matrix(cfg, "f64", CPU)
    b = torch.ones(A.nr, dtype=torch.float64)
    program.cg_loop("standard")(A, b, torch.zeros_like(b), 9, 0.0)
    recorder.set_mode("auto")
    spans = recorder.spans()
    build = [s for s in spans if s.name == "crs.build"]
    assert [s.attrs for s in build] == [
        {"n": 120, "points": 27, "row_ptr": "i64", "nnz": A.nnz}]
    calls = [s for s in spans if s.name == "crs.spmv"]
    assert len(calls) == 9
    assert all(s.attrs == {"kernel": "torch", "nnz": A.nnz, "row_ptr": "i64"}
               for s in calls)
    assert recorder.counts().get("crs_spmv.wide", 0) == 0
    assert recorder.counts().get("crs_spmv.launches", 0) == 0
    assert crs_spmv.launches == launches

