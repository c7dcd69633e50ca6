"""The matrix-free HPCG deployment (``--fmt stencil --cg-variant vmem``):
``cg_vmem_loop`` on ``StencilOperator.from_stencil``, r0 through the
stencil apply (K2 on a card) and the whole solve in one launch of K5
(``ops/stencil_cg_vmem.py``, ``csrc/stencil_cg_vmem.cu``), held to the
benchmark's plain f64 reference (``bench_torch/reference/hpcg.py``) by
the numbers and limits of its cell ``hpcg27-200-mfree.vmem``
(``bench_torch/limits/hpcg27-200-mfree.vmem.json``), without the JAX
package.

Here on the CPU, at 20 x 19 x 18 with 60 iterations (few enough that no
f32 residual underflows) on seeded x* and b = A x*: the f32 solve within
the limits, the control (bf16 vectors) outside them, k = itermax, and the
spans and counter the solve records. The tests marked ``cuda`` (on a
card: ``python -m pytest tests/test_torch_mfree.py --noconftest -q``)
count one K5 launch a solve and hold a 200^3 solve to the limits.
"""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.stencil import StencilOperator
from sparsebench_tpu_torch.ops.stencil_cg_vmem import stencil_cg_vmem
from sparsebench_tpu_torch.solvers.cg import cg_vmem_loop

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench_torch"
CELL = "hpcg27-200-mfree.vmem"
SMALL = {"nx": 20, "ny": 19, "nz": 18, "itermax": 60}
SEEDS = [2**31 + 3, 2**31 + 57, 2**33 + 1]
F32 = DTypePolicy.from_names("f32")


def _reference():
    path = BENCH / "reference" / "hpcg.py"
    spec = importlib.util.spec_from_file_location("bench_reference_hpcg",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


hpcg = _reference()
LIMITS = json.loads((BENCH / "limits" / f"{CELL}.json").read_text())
CONFIG = json.loads((BENCH / "configs" / "hpcg27-200-mfree.json")
                    .read_text())
HIST_FROM = json.loads((BENCH / "traffic" / "vmem.json").read_text())[
    "hist_from"]


@pytest.fixture
def recorder():
    profiler.RECORDER.clear()
    yield profiler
    profiler.set_mode("auto")
    profiler.RECORDER.clear()


def solve(cfg, seed, vectors, device="cpu"):
    """The cell's numbers of one solve from x = 0 on seeded b = A x* (x*
    uniform in [0, 1), b the reference's f64 product rounded once to
    ``vectors``): {"x_err", "hist_err", "iters"} and the solve's k."""
    dims = cfg["nx"], cfg["ny"], cfg["nz"]
    A, _ = StencilOperator.from_stencil(*dims, device=device,
                                        policy=DTypePolicy.from_names(
                                            vectors))
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = torch.rand(A.nr, generator=gen, dtype=torch.float64, device=device)
    b = hpcg.apply(xs, cfg).to(
        {"f32": torch.float32, "bf16": torch.bfloat16}[vectors])
    x, k, hist = cg_vmem_loop(A, b, torch.zeros_like(b), cfg["itermax"],
                              cfg["eps"])
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
    return numbers, int(k)


def small_cfg():
    return dict(CONFIG, **SMALL)


def test_the_configuration_is_the_matrix_free_hpcg_command():
    assert (CONFIG["format"], CONFIG["operator"]) == ("stencil",
                                                      "matrix-free")
    assert (CONFIG["nx"], CONFIG["ny"], CONFIG["nz"]) == (200, 200, 200)
    assert (CONFIG["itermax"], CONFIG["eps"]) == (150, 0.0)
    assert "values" not in CONFIG
    assert CONFIG["reduced"] == CONFIG["assumed"] == []


@pytest.mark.parametrize("seed", SEEDS)
def test_the_solve_is_within_the_cells_limits(seed):
    cfg = small_cfg()
    numbers, k = solve(cfg, seed, "f32")
    assert k == cfg["itermax"]
    for name, value in numbers.items():
        assert value <= LIMITS[name]["limit"], (name, value)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_outside_the_cells_limits(seed):
    """bf16 vectors, which the loop widens to f32: b and x are rounded, so
    at least one number fails its limit."""
    cfg = small_cfg()
    numbers, k = solve(cfg, seed, "bf16")
    assert k == cfg["itermax"]
    assert any(value > LIMITS[name]["limit"]
               for name, value in numbers.items()), numbers


def test_a_solve_records_its_spans(recorder):
    """cg.solve holds cg.init (holding the apply of r0) and then K5's
    span; the plain version on the CPU counts no launch."""
    recorder.set_mode("on")
    A, _ = StencilOperator.from_stencil(6, 5, 4, device="cpu", policy=F32)
    b = torch.ones(A.nr)
    launches = stencil_cg_vmem.launches
    cg_vmem_loop(A, b, torch.zeros_like(b), 9, 0.0)
    recorder.set_mode("auto")
    spans = recorder.spans()
    assert [s.name for s in spans] == ["stencil.build", "cg.solve",
                                       "cg.init", "stencil.apply",
                                       "stencil.cg_vmem"]
    build, solve_, init, apply, k5 = spans
    assert build.attrs == {"n": 120, "points": 27} and build.parent is None
    assert [s.parent for s in (init, apply, k5)] == [1, 2, 1]
    assert apply.attrs == {"kernel": "torch"}
    assert k5.attrs == {"kernel": "torch", "n": 120, "itermax": 9}
    assert init.end_ns <= k5.start_ns and k5.end_ns <= solve_.end_ns
    assert recorder.counts().get("stencil_cg_vmem.launches") is None
    assert stencil_cg_vmem.launches == launches


def test_the_recorder_off_records_nothing(recorder):
    A, _ = StencilOperator.from_stencil(6, 5, 4, device="cpu", use_7pt=True)
    b = torch.ones(A.nr, dtype=torch.float64)
    cg_vmem_loop(A, b, torch.zeros_like(b), 5, 0.0)
    A.spmv(b)
    assert recorder.spans() == [] and recorder.counts() == {}


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_solve_is_one_k5_launch(recorder, cuda_device):
    """Each solve counts one K5 launch, by the wrapper and by the
    recorder's counter, inside its span, which names K5's plan; r0 is
    K2's."""
    A, _ = StencilOperator.from_stencil(48, 40, 36, device=cuda_device,
                                        policy=F32)
    b = torch.rand(A.nr, device=cuda_device)
    launches = stencil_cg_vmem.launches
    recorder.set_mode("on")
    for _ in range(3):
        cg_vmem_loop(A, b, torch.zeros_like(b), 30, 0.0)
    torch.cuda.synchronize()
    recorder.set_mode("auto")
    assert stencil_cg_vmem.launches - launches == 3
    assert recorder.counts()["stencil_cg_vmem.launches"] == 3
    k5 = [s for s in recorder.spans() if s.name == "stencil.cg_vmem"]
    assert len(k5) == 3
    for s in k5:
        assert s.attrs["kernel"] == "K5" and s.attrs["n"] == A.nr
        assert {"r", "tz", "blocks"} <= set(s.attrs)
        assert s.attrs["blocks"] >= 1 and s.attrs["form"] == "march"
    assert recorder.counts().get("stencil_cg_vmem.ring") is None
    applies = [s for s in recorder.spans() if s.name == "stencil.apply"]
    assert [s.attrs["kernel"] for s in applies] == ["K2"] * 3


@pytest.mark.cuda
def test_a_200_cubed_solve_runs_the_ring(recorder, cuda_device):
    """At the cell's grid K5 takes the ring form: every launch counts
    ``stencil_cg_vmem.ring`` beside ``stencil_cg_vmem.launches``, and its
    span names the form."""
    A, _ = StencilOperator.from_stencil(200, 200, 200, device=cuda_device,
                                        policy=F32)
    b = torch.rand(A.nr, device=cuda_device)
    recorder.set_mode("on")
    for _ in range(2):
        cg_vmem_loop(A, b, torch.zeros_like(b), 20, 0.0)
    torch.cuda.synchronize()
    recorder.set_mode("auto")
    counts = recorder.counts()
    assert counts["stencil_cg_vmem.ring"] == counts[
        "stencil_cg_vmem.launches"] == 2
    k5 = [s for s in recorder.spans() if s.name == "stencil.cg_vmem"]
    assert [s.attrs["form"] for s in k5] == ["ring"] * 2


@pytest.mark.cuda
def test_the_200_cubed_solve_is_within_the_cells_limits(cuda_device):
    numbers, k = solve(CONFIG, SEEDS[0], "f32", device=cuda_device)
    assert k == CONFIG["itermax"]
    for name, value in numbers.items():
        assert value <= LIMITS[name]["limit"], (name, value)
