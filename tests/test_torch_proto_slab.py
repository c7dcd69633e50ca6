"""Port parity of P3 and P4, the slab slice-loop prototypes
(sparsebench_tpu_torch/benchmarks/slab_micro.py, slab_micro2.py and
ops/slab_slices.py), against the JAX prototypes benchmarks/slab_micro.py and
benchmarks/slab_micro2.py (``run_variant``), imported by path and run
through Pallas's interpreter on the same numpy-seeded inputs.

P3: all eight variants with bf16 and with f32 values at the JAX script's
check size (5 slices, 3 tiles, its ``build_inputs``). P4: each SUB in {8,
16, 32, 64} and each variant with bf16 values (2 slices a tile, 2 tiles).
Tolerance: the forward-error bound of an S-term f32 sum of products in any
order, with or without contraction, |y_port - y_jax| <= S eps (|v| |g|),
where (|v| |g|) is the plain version run on |vals| and |x|. Against the
numpy oracle of the JAX script (``reference_result``), which sums in the
same order with each operation rounded, the plain version is exact.
"""

import importlib.util
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparsebench_tpu_torch.benchmarks import slab_micro as port3
from sparsebench_tpu_torch.ops.slab_slices import (
    P3,
    P4,
    slab_slices,
    slab_slices_tall,
    slab_slices_torch,
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
def jax_p3():
    """The JAX prototypes, loaded when a test needs them (not on import:
    the card's tests run without JAX)."""
    return load_prototype("slab_micro")


@pytest.fixture(scope="module")
def jax_p4():
    return load_prototype("slab_micro2")


def to_torch(a) -> torch.Tensor:
    """A JAX array as a torch CPU tensor (bf16 through f32: exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_within_bound(got, want, meta, x2d, vals, lidx, table, lane):
    S = vals.shape[1]
    bound = slab_slices_torch(meta, x2d.abs(), vals.abs(), lidx, table, lane)
    diff = (got - torch.from_numpy(np.array(want))).abs()
    assert bool((diff <= S * EPS * bound).all())


@pytest.fixture(scope="module")
def p3_inputs(jax_p3):
    """The JAX script's check inputs (jnp) and the same as torch."""
    rng = np.random.default_rng(0)
    arrays = jax_p3.build_inputs(5, 3, rng)
    return arrays, tuple(to_torch(a) for a in arrays)


@pytest.mark.parametrize("val_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("variant", list(P3))
def test_p3_matches_jax(variant, val_dtype, p3_inputs, jax_p3):
    import jax.numpy as jnp

    (x2d, vals, lidx, m_slab, m_slab_a, m_sc), torch_in = p3_inputs
    metas = {"scatter8": m_sc, "slab_a": m_slab_a}
    meta = metas.get(variant, m_slab)
    with_lidx = dict(jax_p3.VARIANTS)[variant]
    if val_dtype == "f32":
        vals = vals.astype(jnp.float32)
    want = jax_p3.run_variant(meta, x2d, vals, lidx, variant=variant, s_max=5,
                              with_lidx=with_lidx, interpret=True)
    x_t, v_t, l_t, ms_t, msa_t, msc_t = torch_in
    meta_t = {"scatter8": msc_t, "slab_a": msa_t}.get(variant, ms_t)
    if val_dtype == "f32":
        v_t = v_t.float()
    before = slab_slices.launches
    got = slab_slices(meta_t, x_t, v_t, l_t, variant)
    assert slab_slices.launches == before  # the CPU runs the plain version
    assert got.shape == (3, 8, 128)
    assert_within_bound(got, want, meta_t, x_t, v_t, l_t, *P3[variant])


@pytest.mark.parametrize("variant", list(P3))
def test_p3_plain_equals_numpy_oracle(variant, p3_inputs, jax_p3):
    x_t, v_t, l_t, ms_t, msa_t, msc_t = p3_inputs[1]
    meta = port3.metas_of(ms_t, msa_t, msc_t)[variant]
    got = slab_slices(meta, x_t, v_t, l_t, variant).numpy()
    want = port3.reference_result(variant, meta, x_t, v_t, l_t)
    np.testing.assert_array_equal(got, want)
    # the JAX script's own oracle agrees with the port's copy of it
    jwant = jax_p3.reference_result(variant, meta.numpy(), x_t.numpy(),
                                    v_t.float().numpy(), l_t.numpy(),
                                    dict(jax_p3.VARIANTS)[variant])
    np.testing.assert_array_equal(want, jwant)


@pytest.mark.parametrize("variant", list(P4))
@pytest.mark.parametrize("sub", [8, 16, 32, 64])
def test_p4_matches_jax(sub, variant, jax_p4):
    import jax.numpy as jnp

    rng = np.random.default_rng(sub)
    n_tiles, s_max = 2, 2
    n_xrows = n_tiles * sub + 64
    x2d = rng.standard_normal((n_xrows, 128)).astype(np.float32)
    lidx = rng.integers(0, 128, (n_tiles, s_max, sub, 128)).astype(np.int8)
    meta = port3.slab_meta(s_max, n_tiles, sub, n_xrows)[0].numpy()
    vals = rng.standard_normal((n_tiles, s_max, sub, 128)).astype(np.float32)
    vals_j = jnp.asarray(vals).astype(jnp.bfloat16)
    want = jax_p4.run_variant(meta, x2d, vals_j, lidx, variant=variant,
                              s_max=s_max, sub=sub, interpret=True)
    args = (torch.from_numpy(meta), torch.from_numpy(x2d), to_torch(vals_j),
            torch.from_numpy(lidx))
    before = slab_slices_tall.launches
    got = slab_slices_tall(*args, variant)
    assert slab_slices_tall.launches == before
    assert got.shape == (n_tiles, sub, 128)
    assert_within_bound(got, want, *args, *P4[variant])


def test_outside_the_table_reads_nan():
    x2d = torch.ones((16, 128))
    vals = torch.ones((1, 2, 8, 128))
    lidx = torch.zeros((1, 2, 8, 128), dtype=torch.int8)
    lidx[0, 0, 0, 0] = -1
    meta = torch.tensor([[[0, 0], [9, 0]]], dtype=torch.int32)  # rows 9-16
    y = slab_slices(meta, x2d, vals, lidx, "slab_u")
    assert torch.isnan(y[0, 0, 0]) and torch.isnan(y[0, 7]).all()
    assert bool((y[0, 1:7] == 2).all())


@pytest.mark.parametrize("case", ["variant", "sub", "meta", "lidx", "dtype"])
def test_refusals(case):
    x2d = torch.zeros((64, 128))
    vals = torch.zeros((2, 3, 8, 128))
    lidx = torch.zeros((2, 3, 8, 128), dtype=torch.int8)
    meta = torch.zeros((2, 3, 8), dtype=torch.int32)
    variant = "scatter8"
    if case == "variant":
        variant = "roll"  # P4's, not P3's
    elif case == "sub":
        vals, lidx = vals[:, :, :6], lidx[:, :, :6]
    elif case == "meta":
        meta = meta[:, :, :2]  # scatter8 needs a row per sublane
    elif case == "lidx":
        lidx = lidx.long()
    else:
        vals = vals.double()
    with pytest.raises(ValueError, match="slab_slices"):
        slab_slices(meta, x2d, vals, lidx, variant)


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


def test_slab_micro_module_on_cpu(monkeypatch, capsys):
    rc, line = run_module_main(monkeypatch, capsys, "slab_micro",
                               ["--device", "cpu"])
    assert rc == 0 and line["device"] == "cpu"
    for variant in P3:
        assert line[f"{variant}_oracle_err"] == 0.0


def test_slab_micro2_module_on_cpu(monkeypatch, capsys):
    rc, line = run_module_main(monkeypatch, capsys, "slab_micro2",
                               ["64", "--device", "cpu"])
    assert rc == 0 and line["device"] == "cpu"
    keys = [f"sub{s}_{d}_{v}_finite" for s in (8, 16, 32, 64)
            for d in ("bf16", "f32") for v in P4]
    assert all(line[k] is True for k in keys)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("val_dtype", [torch.bfloat16, torch.float32])
def test_p3_kernel_matches_plain(val_dtype, cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x2d, vals, lidx, ms, msa, msc = port3.build_inputs(
        7, 33, gen, val_dtype=val_dtype, device=cuda_device)
    for variant, meta in port3.metas_of(ms, msa, msc).items():
        before = slab_slices.launches
        y = slab_slices(meta, x2d, vals, lidx, variant)
        assert slab_slices.launches == before + 1
        want = slab_slices_torch(meta, x2d, vals, lidx, *P3[variant])
        assert torch.equal(y.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("sub", [8, 16, 32, 64])
def test_p4_kernel_matches_plain(sub, cuda_device):
    from sparsebench_tpu_torch.benchmarks.slab_micro2 import (
        draw_vals,
        sub_inputs,
    )

    gen = torch.Generator(device=cuda_device).manual_seed(sub)
    n_tiles, x2d, lidx, meta = sub_inputs(640, sub, gen, cuda_device)
    for val_dtype in (torch.bfloat16, torch.float32):
        vals = draw_vals((n_tiles, 16, sub, 128), gen, cuda_device).to(
            val_dtype)
        for variant in P4:
            before = slab_slices_tall.launches
            y = slab_slices_tall(meta, x2d, vals, lidx, variant)
            assert slab_slices_tall.launches == before + 1
            want = slab_slices_torch(meta, x2d, vals, lidx, *P4[variant])
            assert torch.equal(y.view(torch.int32), want.view(torch.int32))
