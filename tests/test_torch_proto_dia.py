"""Port parity of P1 and P2, the DIA window prototypes
(sparsebench_tpu_torch/benchmarks/dia_micro.py, dia_shear.py and
ops/dia_window.py), against the JAX prototypes benchmarks/dia_micro.py
(``run_variant``) and benchmarks/dia_shear.py (``run``), imported by path and
run through Pallas's interpreter, with the real 200^3 shifts (10 q-groups,
one straddling a 128 boundary) on small grids.

Each card schedule is held to every JAX variant that it stands for
(``TPU_SCHEDULE``): roll1 and carry_roll to ``direct``, grp_carry and
grp_align to ``grouped``, qfloor and floor to theirs; P2's roll and
shear_chunk to theirs, on a grid that is not a multiple of tpc. Tolerance:
the forward-error bound of a 27-term f32 sum of products in any order, with
or without contraction, |y_port - y_jax| <= 27 eps (|data| |x|)_i, where
(|data| |x|)_i is the plain version run on |data| and |x|.
"""

import importlib.util
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparsebench_tpu_torch.benchmarks.dia_micro import (
    span_rows,
    stencil_shifts,
)
from sparsebench_tpu_torch.ops.dia_window import (
    SCHEDULES,
    TPU_SCHEDULE,
    dia_shear,
    dia_window,
    dia_window_torch,
    shear_x_floats,
    shift_plan,
)

REPO = Path(__file__).resolve().parent.parent
EPS = float(np.finfo(np.float32).eps)


def load_prototype(name: str):
    """benchmarks/<name>.py (not a package) as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_prototype_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_p1():
    """The JAX prototypes, loaded when a test needs them (not on import:
    the card's tests run without JAX)."""
    return load_prototype("dia_micro")


@pytest.fixture(scope="module")
def jax_p2():
    return load_prototype("dia_shear")


P1_VARIANTS = ("roll1", "carry_roll", "grp_carry", "grp_align", "qfloor",
               "floor")
SHIFTS = stencil_shifts()
SPAN = span_rows(SHIFTS)


def inputs(n_rows: int, x_len: int, seed: int):
    """(x numpy f32, data numpy f32 holding bf16 values, x, data torch)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_len).astype(np.float32)
    data = rng.standard_normal((27, n_rows, 128)).astype(np.float32)
    data_t = torch.from_numpy(data).to(torch.bfloat16)
    return x, data_t.float().numpy(), torch.from_numpy(x), data_t


def assert_within_bound(got, want, x, data, shifts, schedule):
    bound = dia_window_torch(x.abs(), data.abs(), shifts, schedule)
    assert bool(((got - torch.from_numpy(np.array(want))).abs()
                 <= 27 * EPS * bound).all())


def test_shifts_and_plan_match_jax(jax_p1, jax_p2):
    assert P1_VARIANTS == jax_p1.VARIANTS
    assert SHIFTS == jax_p1.stencil_shifts() == jax_p2.stencil_shifts()
    assert shift_plan(SHIFTS) == jax_p1._shift_plan(SHIFTS)
    assert len({s // 128 for s in SHIFTS}) == 10 and SPAN == 632
    # one group of three adjacent offsets straddles a 128 boundary
    runs = [SHIFTS[i:i + 3] for i in range(0, 27, 3)]
    assert any(r[0] // 128 != r[-1] // 128 for r in runs)


@pytest.mark.parametrize("variant", P1_VARIANTS)
def test_p1_matches_jax(variant, jax_p1):
    tile, grid = 8, 3
    n_rows = tile * grid
    x, data, x_t, data_t = inputs(n_rows, (n_rows + SPAN) * 128, 1)
    import jax.numpy as jnp

    want = jax_p1.run_variant(jnp.asarray(x), jnp.asarray(data).astype(
        jnp.bfloat16), variant=variant, shifts=SHIFTS, rows=tile, span=SPAN,
        interpret=True)
    before = dia_window.launches
    got = dia_window(x_t, data_t, SHIFTS, TPU_SCHEDULE[variant], tile)
    assert dia_window.launches == before  # the CPU runs the plain version
    assert got.shape == (n_rows, 128)
    assert_within_bound(got, want, x_t, data_t, SHIFTS,
                        TPU_SCHEDULE[variant])


@pytest.mark.parametrize("variant", ["roll", "shear_chunk"])
def test_p2_matches_jax_partial_chunk(variant, jax_p2):
    rows, grid, tpc = 8, 3, 2
    n_rows = rows * grid
    assert grid % tpc  # the last chunk is partial
    x_len = shear_x_floats(n_rows, rows, tpc, SPAN)
    x, data, x_t, data_t = inputs(n_rows, x_len, grid)
    import jax.numpy as jnp

    want = jax_p2.run(jnp.asarray(x), jnp.asarray(data).astype(jnp.bfloat16),
                      variant=variant, shifts=SHIFTS, rows=rows, span=SPAN,
                      tpc=tpc, interpret=True)
    got = dia_shear(x_t, data_t, SHIFTS, variant, rows, tpc)
    assert_within_bound(got, want, x_t, data_t, SHIFTS, "direct")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_plain_version_against_f64_oracle(schedule):
    """Exact schedules to the f32 summation bound of the f64 oracle; the
    lower bounds read other x than the oracle's (their wrong result)."""
    from sparsebench_tpu_torch.benchmarks.dia_micro import oracle

    x, _d, x_t, data_t = inputs(16, (16 + SPAN) * 128, 5)
    y = dia_window_torch(x_t, data_t, SHIFTS, schedule).double()
    err = (y - oracle(x_t, data_t, SHIFTS)).abs()
    bound = dia_window_torch(x_t.abs(), data_t.abs(), SHIFTS,
                             "direct").double()
    exact = bool((err <= 27 * EPS * bound).all())
    assert exact == (schedule in ("direct", "grouped"))


@pytest.mark.parametrize("case", ["short_x", "rows", "schedule", "tpc",
                                  "shear_x"])
def test_refusals(case):
    n_rows, tile = 16, 8
    x_t = torch.zeros((n_rows + SPAN) * 128)
    data_t = torch.zeros((27, n_rows, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError) as e:
        if case == "short_x":
            dia_window(x_t[:-1000], data_t, SHIFTS, "direct", tile)
        elif case == "rows":
            dia_window(x_t, data_t, SHIFTS, "direct", 12)
        elif case == "schedule":
            dia_window(x_t, data_t, SHIFTS, "shear", tile)
        elif case == "tpc":
            dia_shear(x_t, data_t, SHIFTS, "roll", tile, 0)
        else:  # the chunked layout of 2 tiles a chunk holds more than x
            dia_shear(x_t, data_t, SHIFTS, "shear_chunk", tile, 3)
    if case == "short_x":
        assert str((n_rows + max(SHIFTS) // 128 + 1) * 128) in str(e.value)


def run_module_main(monkeypatch, capsys, name, argv):
    """``python -m sparsebench_tpu_torch.benchmarks.<name> argv``
    in-process; returns (exit code, last stdout line as JSON)."""
    module = f"sparsebench_tpu_torch.benchmarks.{name}"
    monkeypatch.setattr(sys, "argv", [name, *argv])
    # run a fresh copy as __main__, as ``python -m`` does
    monkeypatch.delitem(sys.modules, module, raising=False)
    with pytest.raises(SystemExit) as ex:
        runpy.run_module(module, run_name="__main__", alter_sys=False)
    out = capsys.readouterr().out.strip().splitlines()
    return ex.value.code, json.loads(out[-1])


def test_dia_micro_module_on_cpu(monkeypatch, capsys):
    rc, line = run_module_main(monkeypatch, capsys, "dia_micro",
                               ["8", "3", "--device", "cpu"])
    assert rc == 0 and line["device"] == "cpu"
    assert (line["n_rows"], line["span"], line["q_groups"]) == (24, 632, 10)
    assert line["stands_for"]["direct"] == ["roll1", "carry_roll"]
    assert line["stands_for"]["grouped"] == ["grp_carry", "grp_align"]
    for s in ("direct", "grouped"):
        assert line[f"{s}_err"] < 1e-6
    for s in ("qfloor", "floor"):  # lower bounds, wrong results
        assert line[f"{s}_err"] > 1e-2
    assert "direct_us" not in line  # the CPU times nothing


def test_dia_shear_module_on_cpu(monkeypatch, capsys):
    rc, line = run_module_main(monkeypatch, capsys, "dia_shear",
                               ["8", "3", "2", "--device", "cpu"])
    assert rc == 0 and line["device"] == "cpu"
    assert line["x_floats"] == shear_x_floats(24, 8, 2, SPAN)
    for v in ("roll", "shear_chunk"):
        assert line[f"{v}_err"] < 1e-6


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("tile,grid", [(8, 3), (256, 4)])
def test_p1_kernel_matches_plain(schedule, tile, grid, cuda_device):
    n_rows = tile * grid
    _x, _d, x_t, data_t = inputs(n_rows, (n_rows + SPAN) * 128, grid)
    x_t, data_t = x_t.to(cuda_device), data_t.to(cuda_device)
    before = dia_window.launches
    y = dia_window(x_t, data_t, SHIFTS, schedule, tile)
    assert dia_window.launches == before + 1
    assert bits_equal(y, dia_window_torch(x_t, data_t, SHIFTS, schedule))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["roll", "shear_chunk"])
def test_p2_kernel_matches_plain(variant, cuda_device):
    rows, grid, tpc = 16, 5, 2
    n_rows = rows * grid
    _x, _d, x_t, data_t = inputs(n_rows, shear_x_floats(n_rows, rows, tpc,
                                                        SPAN), 3)
    x_t, data_t = x_t.to(cuda_device), data_t.to(cuda_device)
    before = dia_shear.launches
    y = dia_shear(x_t, data_t, SHIFTS, variant, rows, tpc)
    assert dia_shear.launches == before + 1
    assert bits_equal(y, dia_window_torch(x_t, data_t, SHIFTS,
                                          TPU_SCHEDULE[variant]))
