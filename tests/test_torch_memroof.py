"""Port parity of the read-ceiling kernel's plain version (K12,
sparsebench_tpu_torch/ops/memroof.py) against the JAX package's
``_read_passes``, run through Pallas's interpreter on the CPU, and the
refusals of its wrapper and of ``measure_dma_read_gbps``.

``out`` sums the first 8 rows of tile ``i mod n_tiles`` over the steps i in
order, as the TPU kernel does, so the two agree to the rounding of an f32
sum (rtol 1e-6 on random data) and exactly on ones. ``sink`` holds the
per-block sums of every value read: their total is ``reps`` times the
array's sum, to the bound of the kernel's per-thread serial sums and block
trees.
"""

import functools
import types

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sparsebench_tpu.ops.memroof as jax_memroof
from sparsebench_tpu_torch.ops import memroof
from sparsebench_tpu_torch.ops.memroof import (
    LANES,
    measure_dma_read_gbps,
    read_passes,
    read_passes_torch,
)


@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode for the JAX kernel, in this
    test only."""
    monkeypatch.setattr(jax_memroof.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("tile_rows", [8, 16, 64])
@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("reps", [1, 3])
def test_read_passes_matches_jax(tile_rows, n_tiles, reps, interpret):
    rng = np.random.default_rng(100 * tile_rows + 10 * n_tiles + reps)
    x = rng.standard_normal((n_tiles * tile_rows, LANES)).astype(np.float32)
    out_j = np.asarray(jax_memroof._read_passes(x, n_tiles, reps, tile_rows))
    before = read_passes.launches
    out_t, sink = read_passes(torch.from_numpy(x), n_tiles, reps, tile_rows)
    assert read_passes.launches == before  # the CPU runs the plain version
    assert out_t.shape == (8, LANES) and sink.shape == (tile_rows // 8,)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-6, atol=1e-6)
    # sink: reps x the array's sum, within the bound of the kernel's
    # summation: a value read passes through at most 4 n_steps serial adds
    # in its thread and the 8 levels of its block's tree
    n_steps = reps * n_tiles
    exact = reps * float(np.sum(x, dtype=np.float64))
    tol = (4 * n_steps + 8) * np.finfo(np.float32).eps * reps * float(
        np.abs(x).sum(dtype=np.float64))
    assert abs(float(sink.double().sum()) - exact) <= tol

    ones = np.ones_like(x)
    out_j1 = np.asarray(jax_memroof._read_passes(ones, n_tiles, reps,
                                                 tile_rows))
    out_t1, sink1 = read_passes_torch(torch.from_numpy(ones), n_tiles, reps,
                                      tile_rows)
    np.testing.assert_array_equal(out_t1.numpy(), out_j1)
    assert np.all(out_j1 == reps * n_tiles)
    assert float(sink1.double().sum()) == reps * ones.size


def test_read_passes_reads_only_its_tiles():
    """Rows past n_tiles * tile_rows are not read, as in the JAX kernel."""
    x = torch.ones((3 * 8, LANES))
    x[16:] = float("nan")
    out, sink = read_passes(x, 2, 2, 8)
    assert torch.equal(out, torch.full((8, LANES), 4.0))
    assert float(sink.sum()) == 2 * 16 * LANES


@pytest.mark.parametrize("args,match", [
    ((torch.ones((16, LANES)), 2, 1, 12), "multiple of 8"),
    ((torch.ones((16, LANES)), 0, 1, 8), "n_tiles"),
    ((torch.ones((16, LANES)), 2, 0, 8), "reps"),
    ((torch.ones((16, LANES)), 3, 1, 8), "shape"),
    ((torch.ones((16, 64)), 2, 1, 8), "shape"),
    ((torch.ones((16, LANES), dtype=torch.float64), 2, 1, 8), "f32"),
])
def test_read_passes_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        read_passes(*args)


def test_measure_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        measure_dma_read_gbps()


def test_measure_refuses_an_array_the_l2_holds(monkeypatch):
    """Below 4 x the L2 the later passes would read the L2: refused before
    anything is allocated on the (faked) card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda device: types.SimpleNamespace(L2_cache_size=50 * 2**20))
    with pytest.raises(ValueError, match="L2"):
        measure_dma_read_gbps(n_floats=4 * 50 * 2**20 // 4 - 128)


def test_measure_on_the_cpu_times_the_plain_version():
    before = read_passes.launches
    gbps = measure_dma_read_gbps(n_floats=4 * 8 * LANES, reps=2, trials=1,
                                 tile_rows=8, device="cpu")
    assert gbps > 0 and np.isfinite(gbps)
    assert read_passes.launches == before
    with pytest.raises(ValueError, match="must hold a tile"):
        measure_dma_read_gbps(n_floats=LANES, tile_rows=8, device="cpu")


def test_wrapper_refuses_another_device():
    x = torch.ones((8, LANES), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        memroof.read_passes(x, 1, 1, 8)
