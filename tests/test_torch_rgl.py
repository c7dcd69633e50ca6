"""Port parity: the RGL matrix (the seeded random-graph Laplacian) of
sparsebench_tpu_torch against the JAX package, on the CPU.

The host spec (``mix32``, ``threshold``, ``rgl_csr``) is a numpy copy and
gives the same bits. The device build ``rgl_bslab`` (torch ops, int64
hash arithmetic masked to 32 bits, a scatter where the JAX package
contracts one-hot tensors) gives the JAX package's layout element for
element, for the exact-cap layout, one wide pool forced by ``force_caps``
and grouped pools of span 2 and 3. Its SpMV is held to the host CSR to
rtol 1e-3 in f32 (the JAX tests' tolerance) and 1e-12 in f64, and CG
reaches x = 1.
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats.rgl_build import rgl_bslab as jax_rgl  # noqa: E402
from sparsebench_tpu.host import rgl as jax_host_rgl  # noqa: E402
from sparsebench_tpu_torch import host  # noqa: E402
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab  # noqa: E402
from sparsebench_tpu_torch.solvers.cg import solve_cg  # noqa: E402
from test_torch_bslab import assert_same_bslab  # noqa: E402

CPU = torch.device("cpu")


def n_buckets(band):
    return (band + 127) // 128 + (127 + band) // 128 + 1


def test_hash_and_threshold_equal_jax():
    rng = np.random.default_rng(0)
    lo = rng.integers(0, 2**31 - 1, 5000)
    hi = rng.integers(0, 2**31 - 1, 5000)
    for seed in (0, 1, 12345, 2**32 - 1):
        np.testing.assert_array_equal(host.mix32(lo, hi, seed),
                                      jax_host_rgl.mix32(lo, hi, seed))
    for band, deg in ((512, 16.0), (96, 8.0), (1, 4.0), (10, 100.0)):
        assert host.threshold(band, deg) == jax_host_rgl.threshold(band, deg)


@pytest.mark.parametrize("n,band,deg,seed", [(800, 96, 8.0, 3),
                                             (3000, 200, 12.0, 5)])
def test_rgl_csr_equals_jax(n, band, deg, seed):
    c_t = host.rgl_csr(n, band=band, deg=deg, seed=seed)
    c_j = jax_host_rgl.rgl_csr(n, band=band, deg=deg, seed=seed)
    for f in ("row_ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(c_t, f), getattr(c_j, f))
    assert (c_t.nr, c_t.nc, c_t.nnz) == (c_j.nr, c_j.nc, c_j.nnz)
    np.testing.assert_array_equal(c_t.spmv(np.ones(n)), np.ones(n))
    np.testing.assert_array_equal(c_t.diagonal(), c_j.diagonal())


# (n, band, deg, seed, sub, options): the exact caps (tail=False), the
# default cost-model choice, one wide pool (force_caps), grouped pools of
# span 2 and 3
LAYOUTS = {
    "exact": (700, 96, 8.0, 5, 8, dict(tail=False)),
    "default": (3000, 200, 10.0, 5, 16, {}),
    "bytes": (3000, 128, 12.0, 9, 8, dict(objective="bytes")),
    "one_pool": (700, 96, 8.0, 5, 8, dict(force_caps=(1,) * 3)),
    "span2": (900, 128, 10.0, 11, 8,
              dict(force_caps=(1,) * 3, force_span=2)),
    "span3": (1500, 256, 10.0, 11, 8,
              dict(force_caps=(1,) * n_buckets(256), force_span=3)),
}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rgl_bslab_arrays_equal_jax(layout, dtype):
    n, band, deg, seed, sub, opts = LAYOUTS[layout]
    Aj, nnz_j = jax_rgl(n, band=band, deg=deg, seed=seed, sub=sub,
                        policy=JaxPolicy.from_names(dtype, "i32"), impl="xla",
                        **opts)
    At, nnz_t = rgl_bslab(n, band=band, deg=deg, seed=seed, sub=sub,
                          policy=DTypePolicy.from_names(dtype), device=CPU,
                          **opts)
    assert nnz_t == nnz_j
    if "force_caps" in opts:
        assert At.s_wide > 0
        assert At.wide_k == opts.get("force_span", n_buckets(band))
    assert_same_bslab(At, Aj)
    assert At.impl == "torch"


@pytest.mark.parametrize("dtype,rtol", [("f32", 1e-3), ("f64", 1e-12)])
@pytest.mark.parametrize("layout", ["exact", "one_pool", "span2", "span3"])
def test_rgl_spmv_matches_host_csr(layout, dtype, rtol):
    n, band, deg, seed, sub, opts = LAYOUTS[layout]
    A, nnz = rgl_bslab(n, band=band, deg=deg, seed=seed, sub=sub,
                       policy=DTypePolicy.from_names(dtype), device=CPU, **opts)
    csr = host.rgl_csr(n, band=band, deg=deg, seed=seed)
    assert nnz == csr.nnz
    x = np.random.default_rng(seed).standard_normal(n)
    y = A.spmv(torch.from_numpy(x).to(DTypePolicy.from_names(dtype).value))
    want = csr.spmv(x)
    assert np.abs(y.double().numpy() - want).max() <= rtol * np.abs(
        want).max()


@pytest.mark.parametrize("layout", ["exact", "span2"])
def test_rgl_cg_reaches_ones(layout):
    """b = A 1 = 1 (row sums are 1); a random b also converges, to the
    host CSR's solution."""
    n, band, deg, seed, sub, opts = LAYOUTS[layout]
    A, _ = rgl_bslab(n, band=band, deg=deg, seed=seed, sub=sub,
                     policy=DTypePolicy.from_names("f64"), device=CPU, **opts)
    res = solve_cg(A, np.ones(n), itermax=50, verbose=False)
    assert np.abs(res.x - 1).max() < 1e-12
    b = np.random.default_rng(1).standard_normal(n)
    res = solve_cg(A, b, itermax=300, eps=1e-12, verbose=False)
    csr = host.rgl_csr(n, band=band, deg=deg, seed=seed)
    assert np.abs(csr.spmv(res.x) - b).max() < 1e-10


def test_rgl_refuses_what_the_layout_cannot_take():
    f32 = DTypePolicy.from_names("f32")
    with pytest.raises(ValueError, match="band"):
        rgl_bslab(100, band=100, device=CPU, policy=f32)
    with pytest.raises(ValueError, match="unknown bslab impl"):
        rgl_bslab(256, band=16, deg=4.0, device=CPU, policy=f32, sub=8,
                  impl="palas")
    with pytest.raises(ValueError, match="CUDA kernel"):
        rgl_bslab(256, band=16, deg=4.0, device=CPU, policy=f32, sub=8,
                  impl="kernel_win")
    with pytest.raises(ValueError, match="lead pad"):
        rgl_bslab(3000, band=1100, deg=4.0, device=CPU, policy=f32, sub=8,
                  force_caps=(1,) * n_buckets(1100))
