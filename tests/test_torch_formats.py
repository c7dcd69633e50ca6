"""Port parity: the host SELL conversion, the SELL, ELL, CRS and CCRS
device formats and the RCM reordering of sparsebench_tpu_torch against the
JAX package, on the CPU.

``scs_host`` dumps equal the reference's golden files line for line, as
tests/test_scs_golden.py holds the JAX package's. ``SellMatrix``'s blocks and
permutations equal JAX's element for element, and the SpMV of SELL (its
permuted gather path), ELL, CRS and CCRS is held to JAX's to 1e-13 (f64) and
1e-6 (f32) of max_i (|A||x|)_i. ``rcm_permutation`` and ``permute_csr``
equal JAX's.
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats import from_csr as jax_from_csr  # noqa: E402
from sparsebench_tpu.formats import scs_host as jax_scs  # noqa: E402
from sparsebench_tpu.host import HostCSR as JaxCSR  # noqa: E402
from sparsebench_tpu.host import rcm as jax_rcm  # noqa: E402
from sparsebench_tpu.host import read_mm as jax_read_mm  # noqa: E402
from sparsebench_tpu_torch import host  # noqa: E402
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats import from_csr, get_format  # noqa: E402
from sparsebench_tpu_torch.formats import scs_host  # noqa: E402
from sparsebench_tpu_torch.formats.base import physical_spmv_bytes  # noqa: E402
from sparsebench_tpu_torch.formats.bsell import BsellMatrix  # noqa: E402
from sparsebench_tpu_torch.formats.bslab import BslabMatrix  # noqa: E402
from sparsebench_tpu_torch.formats.crs import CCRSMatrix, CRSMatrix  # noqa: E402
from sparsebench_tpu_torch.formats.sell import EllMatrix, SellMatrix  # noqa: E402
from test_torch_bslab import CSR_CASES, TOL, to_port  # noqa: E402

CPU = torch.device("cpu")
NP_DT = {"f64": np.float64, "f32": np.float32}


def port_mm(path):
    return host.read_mm(str(path))


@pytest.mark.parametrize("name", ["test0", "test8"])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_scs_golden_dumps(test_matrices_dir, expected_dir, name, C):
    m = scs_host.sell_convert(port_mm(test_matrices_dir / f"{name}.mtx"),
                              C=C, sigma=1)
    got = scs_host.dump_reference_format(m)
    expected = (expected_dir / f"{name}_C_{C}_sigma_1.in").read_text()
    assert got.splitlines() == expected.splitlines()


@pytest.mark.parametrize("C,sigma", [(1, 1), (3, 5), (8, 8), (4, 100)])
@pytest.mark.parametrize("name", ["test0", "test8", "test9"])
def test_scs_host_equals_jax_and_its_spmv_the_csr(test_matrices_dir, name, C,
                                                  sigma):
    path = test_matrices_dir / f"{name}.mtx"
    c_t = port_mm(path)
    m_t = scs_host.sell_convert(c_t, C=C, sigma=sigma)
    m_j = jax_scs.sell_convert(JaxCSR.from_coo(jax_read_mm(str(path))), C=C,
                               sigma=sigma)
    for f in ("chunk_ptr", "chunk_lens", "col", "val", "old_to_new",
              "new_to_old"):
        np.testing.assert_array_equal(getattr(m_t, f), getattr(m_j, f))
    x = np.random.default_rng(0).standard_normal(c_t.nc)
    y = scs_host.sell_spmv_host(m_t, x)[m_t.old_to_new]
    np.testing.assert_allclose(y, c_t.spmv(x), rtol=1e-13, atol=1e-13)


def spmv_bound(cj, x):
    b = to_port(cj)
    b.val = np.abs(b.val)
    return b.spmv(np.abs(x))


FORMAT_CASES = ["stencil10x9x7", "klein", "random", "rect", "test0", "test8",
                "empty"]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", FORMAT_CASES)
@pytest.mark.parametrize("fmt", ["sell", "ell", "crs", "ccrs"])
def test_spmv_matches_jax(fmt, case, dtype):
    """SELL on its permuted gather path (the CPU's), ELL, CRS and CCRS."""
    cj = CSR_CASES[case]()
    Aj = jax_from_csr(fmt, cj, JaxPolicy.from_names(dtype, "i32"),
                      bridge=False)
    At = from_csr(fmt, to_port(cj), DTypePolicy.from_names(dtype), device=CPU)
    assert At.impl == "torch"
    x = np.random.default_rng(cj.nr).standard_normal(cj.nc).astype(
        NP_DT[dtype])
    y_j = np.asarray(jax.jit(lambda A, v: A.spmv(v))(Aj, jnp.asarray(x)))
    y_t = At.spmv(torch.from_numpy(x))
    assert y_t.shape == (cj.nr,) and y_t.dtype == torch.from_numpy(x).dtype
    err = np.abs(y_t.numpy().astype(np.float64) - y_j)
    assert err.max(initial=0) <= TOL[dtype] * spmv_bound(cj, x).max(initial=0)
    assert At.permuted_output == (fmt == "sell")


@pytest.mark.parametrize("C,sigma", [(0, 0), (1, 1), (4, 8), (32, 1)])
@pytest.mark.parametrize("case", ["random", "test9", "stencil10x9x7"])
def test_sell_layout_equals_jax(case, C, sigma):
    cj = CSR_CASES[case]()
    Aj = jax_from_csr("sell", cj, JaxPolicy.from_names("f64", "i32"), C=C,
                      sigma=sigma, bridge=False)
    At = SellMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f64"),
                             device=CPU, C=C, sigma=sigma)
    for f in ("nr", "nc", "nnz", "C", "sigma", "nr_padded", "n_elems"):
        assert getattr(At, f) == getattr(Aj, f), f
    assert len(At.vals) == len(Aj.vals)
    for a, b in zip(At.vals + At.cols, Aj.vals + Aj.cols):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("old_to_new", "new_to_old"):
        np.testing.assert_array_equal(getattr(At, f).numpy(),
                                      np.asarray(getattr(Aj, f)))
    v = torch.arange(float(At.nr), dtype=torch.float64)
    assert torch.equal(At.unpermute_vector(At.permute_vector(v)), v)
    np.testing.assert_array_equal(At.permute_vector(v).numpy(),
                                  np.asarray(Aj.permute_vector(v.numpy())))


def test_ell_layout_equals_jax():
    cj = CSR_CASES["random"]()
    Aj = jax_from_csr("ell", cj, JaxPolicy.from_names("f64", "i32"))
    At = EllMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f64"),
                            device=CPU)
    np.testing.assert_array_equal(At.val_t.numpy(), np.asarray(Aj.val_t))
    np.testing.assert_array_equal(At.col_t.numpy(), np.asarray(Aj.col_t))
    assert At.n_elems == Aj.n_elems
    with pytest.raises(ValueError, match="lmax"):
        EllMatrix.from_csr(to_port(cj), device=CPU, lmax=1)


def test_bridged_sell_runs_and_counts_its_delegate():
    """bridge=True attaches a bslab delegate on any device: the SpMV runs
    through it in original row order, and the physical bytes count only
    its arrays, as the JAX package counts them."""
    from sparsebench_tpu.formats.base import (
        physical_spmv_bytes as jax_physical_spmv_bytes,
    )

    cj = CSR_CASES["random"]()
    Aj = jax_from_csr("sell", cj, JaxPolicy.from_names("f32", "i32"),
                      bridge=True)
    At = SellMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f32"),
                             device=CPU, bridge=True)
    assert isinstance(At.fast, BslabMatrix) and not At.permuted_output
    assert At.impl == "torch"
    assert physical_spmv_bytes(At, 4) == physical_spmv_bytes(At.fast, 4)
    assert physical_spmv_bytes(At, 4) == jax_physical_spmv_bytes(Aj, 4)
    unbridged = SellMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f32"),
                                    device=CPU)
    assert unbridged.fast is None and unbridged.permuted_output
    assert physical_spmv_bytes(unbridged, 4) != physical_spmv_bytes(At, 4)
    x = np.random.default_rng(1).standard_normal(cj.nc).astype(np.float32)
    y = At.spmv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, cj.spmv(x.astype(np.float64)), rtol=0,
                               atol=1e-6 * spmv_bound(cj, x).max())


def test_registry_and_crs_guards():
    for name, cls in (("sell", SellMatrix), ("ell", EllMatrix),
                      ("crs", CRSMatrix), ("ccrs", CCRSMatrix),
                      ("bslab", BslabMatrix)):
        assert get_format(name) is cls
    assert get_format("bsell") is BsellMatrix  # ported (Queue 1 item 10)
    A = CRSMatrix.from_csr(to_port(CSR_CASES["empty"]()), device=CPU)
    assert torch.equal(A.spmv(torch.ones(10)), torch.zeros(10))


@pytest.mark.parametrize("case", ["random", "test9", "klein", "banded"])
def test_rcm_and_permute_csr_equal_jax(case):
    cj = CSR_CASES[case]()
    if cj.nr != cj.nc:
        pytest.skip("RCM needs a square matrix")
    ct = to_port(cj)
    perm = host.rcm_permutation(ct)
    np.testing.assert_array_equal(perm, jax_rcm.rcm_permutation(cj))
    np.testing.assert_array_equal(host._rcm_numpy(ct),
                                  jax_rcm._rcm_numpy(cj))
    pt, pj = host.permute_csr(ct, perm), jax_rcm.permute_csr(cj, perm)
    for f in ("row_ptr", "col", "val"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
    np.testing.assert_array_equal(host.inverse_permutation(perm),
                                  jax_rcm.inverse_permutation(perm))
    x = np.random.default_rng(2).standard_normal(ct.nr)
    inv = host.inverse_permutation(perm)
    np.testing.assert_allclose(pt.spmv(x[perm])[inv], ct.spmv(x), rtol=1e-12,
                               atol=1e-12)
