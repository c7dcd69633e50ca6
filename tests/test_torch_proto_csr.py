"""Port parity of P5, the compact row-block CSR prototype
(sparsebench_tpu_torch/benchmarks/csr_twopass_proto.py and
ops/csr_twopass.py), against the JAX prototype benchmarks/csr_twopass_proto.py,
imported by path, its ``pass1_products`` run through Pallas's interpreter.

Tolerances:
- the device build is integer and selection work: every stream equals
  JAX's exactly, at the JAX small size (8192 rows, band 128, R 512) and at
  n = 8000 (192 phantom rows in the last block, where JAX clamps gathers and
  drops scatters and segment ids past n);
- pass 1 is one rounded product of the same two operands: exact;
- the segment-sum variants against the host spec CSR (``rgl_csr``, f64):
  1e-5 of max|y|, the JAX script's own bound; against JAX's variants 1e-6
  (f32 sums of at most 56 terms in another order);
- ``twopass_cumsum`` subtracts two f32 prefix sums of up to 163,840 products:
  each prefix is off by up to a few ulps of the largest prefix, so it is held
  to 64 ulps of max|prefix| (absolute), the loose bound its cancellation
  allows.
"""

import importlib.util
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sparsebench_tpu_torch.benchmarks import csr_twopass_proto as port
from sparsebench_tpu_torch.host import rgl_csr
from sparsebench_tpu_torch.ops.csr_twopass import (
    pass1_products,
    pass1_products_torch,
)

REPO = Path(__file__).resolve().parent.parent


def load_prototype(name: str):
    """benchmarks/<name>.py (not a package) as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_prototype_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_p5():
    """The JAX prototype, loaded when a test needs it (not on import: the
    card's tests run without the JAX package)."""
    return load_prototype("csr_twopass_proto")


# (n, band, rows_per_block): the JAX small size, and one with phantom rows
SIZES = [(8192, 128, 512), (8000, 128, 512)]
STREAMS = ("val", "colrel", "rowseg", "row_ptr", "blk_start")


@pytest.fixture(scope="module")
def builds(jax_p5):
    """{size: (JAX streams as numpy, port streams)}, built once."""
    out = {}
    for n, band, R in SIZES:
        Sj = jax_p5.build_streams(n, band, 16.0, 1, R)
        Sj = {k: (np.asarray(v) if k in STREAMS else v) for k, v in Sj.items()}
        out[(n, band, R)] = (Sj, port.build_streams(n, band, 16.0, 1, R,
                                                    "cpu"))
    return out


@pytest.mark.parametrize("size", SIZES)
def test_build_matches_jax(size, builds):
    Sj, St = builds[size]
    n, _, R = size
    for key in ("nb", "block_cap", "nnz"):
        assert St[key] == Sj[key], key
    for key in STREAMS:
        np.testing.assert_array_equal(St[key].numpy(), Sj[key], err_msg=key)
    assert St["nb"] * R - n == (192 if n == 8000 else 0)
    # padding slots of the last block name a row past n when it has
    # phantom rows: the id that segment_sum(num_segments=n) drops
    past = (St["rowseg"] >= n).any()
    assert bool(past) == (n % R != 0)


@pytest.mark.parametrize("size", SIZES)
def test_pass1_matches_jax(size, builds, jax_p5):
    Sj, St = builds[size]
    n, band, R = size
    xpad = np.random.default_rng(n).standard_normal(
        n + R + 2 * band).astype(np.float32)
    want = np.asarray(jax_p5.pass1_products(
        Sj["val"], Sj["colrel"], xpad, band, R, interpret=True))
    before = pass1_products.launches
    got = pass1_products(St["val"], St["colrel"], torch.from_numpy(xpad),
                         band, R)
    assert pass1_products.launches == before  # the CPU runs the plain version
    np.testing.assert_array_equal(got.numpy(), want)


def test_pass1_window_edges():
    """A colrel outside [0, R + 2 band) reads 0, as the select chain does."""
    val = torch.ones((2, 1, 128))
    colrel = torch.arange(-64, 192, dtype=torch.int32).reshape(2, 1, 128)
    xpad = torch.arange(1.0, 2 * 64 + 128 + 1)  # (nb - 1) R + window floats
    y = pass1_products_torch(val, colrel, xpad, band=32, rows_per_block=64)
    c = colrel.long()
    b = torch.arange(2).view(2, 1, 1)
    inside = (c >= 0) & (c < 128)
    want = torch.where(inside, xpad[(b * 64 + c).clamp(0, xpad.numel() - 1)],
                       torch.zeros(()))
    assert torch.equal(y, want)
    assert int((~inside).sum()) == 128 and float(y[~inside].abs().max()) == 0


@pytest.mark.parametrize("case", ["window", "xpad", "dtype"])
def test_pass1_refusals(case):
    val = torch.zeros((2, 16, 128))
    colrel = torch.zeros((2, 16, 128), dtype=torch.int32)
    xpad = torch.zeros(2 * 1024)
    band, R = 512, 1024
    if case == "window":
        band = 100  # R + 2 band not a multiple of 128
    elif case == "xpad":
        xpad = torch.zeros(1024 + 2048 - 1)
    else:
        colrel = colrel.long()
    with pytest.raises(ValueError, match="pass1_products"):
        pass1_products(val, colrel, xpad, band, R)


@pytest.fixture(scope="module")
def variants_small(builds):
    n, band, R = SIZES[0]
    St = builds[SIZES[0]][1]
    S, fns = port.make_variants(St, n, band, R)
    xr = 0.5 + (torch.arange(n, dtype=torch.float32) % 97) / 97.0
    y_h = rgl_csr(n, band=band, deg=16.0, seed=1).spmv(
        xr.numpy().astype(np.float64))
    return S, fns, xr, y_h


@pytest.mark.parametrize("name", ["twopass_segsum", "csrseg_onepass"])
def test_segment_variants_against_host_csr(name, variants_small):
    _S, fns, xr, y_h = variants_small
    y = fns[name](xr).numpy()
    assert np.abs(y - y_h).max() <= 1e-5 * np.abs(y_h).max()
    assert float((fns[name](torch.ones_like(xr)) - 1).abs().max()) == 0.0


@pytest.mark.parametrize("name", ["twopass_segsum", "twopass_cumsum",
                                  "csrseg_onepass", "pass1_only"])
def test_variants_match_jax(name, builds, variants_small, jax_p5):
    n, band, R = SIZES[0]
    Sj = dict(builds[SIZES[0]][0])
    Sj, jfns = jax_p5.make_variants(Sj, n, band, R, interpret=True)
    _S, fns, xr, _y = variants_small
    want = np.asarray(jfns[name](Sj, xr.numpy()))
    got = fns[name](xr).numpy()
    scale = np.abs(want).max()
    tol = 1e-6 if name != "twopass_cumsum" else 1e-3
    assert np.abs(got - want).max() <= tol * scale


def test_cumsum_variant_within_its_bound(variants_small):
    S, fns, xr, y_h = variants_small
    y = fns["twopass_cumsum"](xr).numpy()
    p = pass1_products(S["val"], S["colrel"], torch.cat([
        torch.zeros(128), xr, torch.zeros(512 + 128)]), 128, 512)
    prefix = np.cumsum(p.numpy().reshape(-1).astype(np.float64))
    tol = 64 * np.finfo(np.float32).eps * np.abs(prefix).max()
    assert np.abs(y - y_h).max() <= tol


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


def test_module_on_cpu(monkeypatch, capsys, tmp_path):
    out = tmp_path / "p5.json"
    rc, line = run_module_main(monkeypatch, capsys, "csr_twopass_proto",
                               [str(out), "--device", "cpu"])
    assert rc == 0 and line["device"] == "cpu"
    assert (line["n"], line["band"], line["rows_per_block"]) == (8192, 128,
                                                                 512)
    assert line["K_window_slabs"] == 6 and line["nnz"] > 8192
    for name in ("twopass_segsum", "twopass_cumsum", "csrseg_onepass"):
        assert line[f"{name}_err_ones"] == 0.0
    assert line["csrseg_onepass_err_cross"] <= 1e-6
    assert line["host_oracle_err"] < 1e-5
    assert "twopass_segsum_ms" not in line  # the CPU times nothing
    assert json.loads(out.read_text()) == line


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES)
def test_kernel_matches_plain(size, cuda_device):
    n, band, R = size
    S = port.build_streams(n, band, 16.0, 1, R, cuda_device)
    xpad = torch.randn(n + R + 2 * band, device=cuda_device)
    before = pass1_products.launches
    y = pass1_products(S["val"], S["colrel"], xpad, band, R)
    assert pass1_products.launches == before + 1
    want = pass1_products_torch(S["val"], S["colrel"], xpad, band, R)
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_device_build_matches_cpu_build(cuda_device):
    n, band, R = SIZES[1]
    St = port.build_streams(n, band, 16.0, 1, R, "cpu")
    Sc = port.build_streams(n, band, 16.0, 1, R, cuda_device)
    for key in STREAMS:
        assert torch.equal(Sc[key].cpu(), St[key]), key


def test_chain_time_on_the_host_clock():
    """The prototypes' differential timer on the CPU (the host clock): a
    positive time a call, raw >= 0 and a spread >= 0; with ``min_diff_s``
    the chain lengthens until the differential spans it."""
    from sparsebench_tpu_torch.benchmarks._chain import chain_time

    calls = []

    def step(u):
        calls.append(1)
        return u + 1.0

    dt, raw, spread = chain_time(step, torch.zeros(1000), reps=2, trials=2,
                                 min_diff_s=1e-3)
    assert dt > 0 and raw > 0 and spread >= 0
    assert len(calls) >= 2 * (2 + 6) + 2 * (2 + 6)  # warm-ups and trials
