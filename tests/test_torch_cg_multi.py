"""Port parity: the multi-RHS DIA product (``DiaMatrix.spmm_kn``, K8's plain
version on the CPU) and simultaneous CG (``solvers/cg_multi.py``) of
sparsebench_tpu_torch against the JAX package's, on the CPU.

Tolerances. ``spmm_kn`` in f64 and f32 sums the same terms in the same
order as the JAX package's XLA path: each entry within ndiag eps (|A||X|)
(any order, with or without FMA contraction). In bf16 the port widens X to
f32 and narrows the result, as the JAX package's Pallas path does (its XLA
path sums in bf16), so the oracle is ``impl="pallas_interpret"``: one bf16
rounding of the same f32 sum, 2^-8 (|A||X|). CG follows ROADMAP's parity
rules per column: in f64 the per-column counts equal and the history to
rtol 1e-9 where normr >= 1e-10 normr0.
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats import from_csr as jax_from_csr  # noqa: E402
from sparsebench_tpu.formats.dia import DiaMatrix as JaxDia  # noqa: E402
from sparsebench_tpu.host import HostCSR as JaxCSR  # noqa: E402
from sparsebench_tpu.host import generate_stencil as jax_generate  # noqa: E402
from sparsebench_tpu.host import read_mm as jax_read_mm  # noqa: E402
from sparsebench_tpu.solvers.cg_multi import (  # noqa: E402
    solve_cg_multi as jax_solve_multi,
)
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats import from_csr  # noqa: E402
from sparsebench_tpu_torch.formats.dia import DiaMatrix  # noqa: E402
from sparsebench_tpu_torch.host import generate_stencil, read_mm  # noqa: E402
from sparsebench_tpu_torch.solvers import cg  # noqa: E402
from sparsebench_tpu_torch.solvers.cg_multi import (  # noqa: E402
    make_spmm_kn,
    solve_cg_multi,
)

CPU = torch.device("cpu")
TORCH_DT = {"f64": torch.float64, "f32": torch.float32,
            "bf16": torch.bfloat16}


def carry(Aj):
    return DiaMatrix.from_jax_arrays(
        np.asarray(Aj.data), Aj.offsets, Aj.nr, Aj.nc, Aj.nnz, Aj.nr_pad,
        Aj.start_row, Aj.total_nr, Aj.total_nnz, device=CPU, impl="torch",
    )


def jax_dia(case, dtype, impl, data_dir):
    jp = JaxPolicy.from_names(dtype, "i32")
    if case == "klein":
        csr = JaxCSR.from_coo(jax_read_mm(str(data_dir /
                                              "matrix_band_klein.mtx")))
        return JaxDia.from_csr(csr, jp, impl=impl)
    return JaxDia.from_stencil(10, 9, 7, policy=jp, impl=impl)[0]


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("case", ["10x9x7", "klein"])
def test_spmm_kn_matches_jax(case, k, dtype, data_dir):
    impl = "pallas_interpret" if dtype == "bf16" else "xla"
    Aj = jax_dia(case, dtype, impl, data_dir)
    At = carry(Aj)
    X = np.random.default_rng(k).standard_normal((k, Aj.nr))
    Xj = jnp.asarray(X, dtype=jnp.bfloat16 if dtype == "bf16" else
                     (jnp.float32 if dtype == "f32" else jnp.float64))
    want = np.asarray(Aj.spmm_kn(Xj).astype(jnp.float64))
    Xt = torch.from_numpy(np.array(Xj.astype(jnp.float64))).to(
        TORCH_DT[dtype])
    got = At.spmm_kn(Xt)
    assert got.dtype == Xt.dtype and got.shape == (k, Aj.nr)
    bound = np.abs(np.asarray(At.data[:, :Aj.nr].double())).sum(0) * \
        np.abs(np.asarray(Xt.double())).max()
    tol = {"f64": len(Aj.offsets) * 2.0 ** -52,
           "f32": len(Aj.offsets) * 2.0 ** -23, "bf16": 2.0 ** -8}[dtype]
    assert (np.abs(got.double().numpy() - want) <= tol * bound).all()
    # row c of the block is the single-vector product of row c, bit for bit
    for c in range(k):
        assert torch.equal(got[c], At.spmv(Xt[c]))


def rhs_block(csr_t, k, seed, dtype=np.float64):
    """(nr, k): column 0 the reference's generated b, the rest seeded."""
    _x, b, _xe = cg.init_vectors(csr_t, dtype=dtype)
    B = np.random.default_rng(seed).standard_normal((b.shape[0], k))
    B[:, 0] = b
    return B.astype(dtype)


def assert_columns_agree(rt, rj, min_entries=5):
    assert rt.x.shape == np.asarray(rj.x).shape
    ht, hj = rt.residual_history, np.asarray(rj.residual_history)
    assert ht.shape == hj.shape
    for c in range(hj.shape[1]):
        hjc = hj[:, c]
        np.testing.assert_array_equal(np.isnan(ht[:, c]), np.isnan(hjc))
        sel = ~np.isnan(hjc) & (hjc >= 1e-10 * hjc[0])
        assert sel.sum() >= min_entries
        np.testing.assert_allclose(ht[sel, c], hjc[sel], rtol=1e-9)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("fmt", ["dia", "bslab"])
def test_cg_multi_matches_jax(fmt):
    """Distinct seeded columns, f64: DIA through spmm_kn, bslab through the
    per-row loop (the JAX package vmaps its spmv)."""
    B = rhs_block(generate_stencil(7, 6, 5), 4, seed=1)
    rj = jax_solve_multi(jax_from_csr(fmt, jax_generate(7, 6, 5)), B,
                         itermax=40, verbose=False)
    A = from_csr(fmt, generate_stencil(7, 6, 5),
                 DTypePolicy.from_names("f64"), device=CPU)
    rt = solve_cg_multi(A, B, itermax=40, verbose=False)
    assert rt.iterations == rj.iterations == 40
    assert_columns_agree(rt, rj)


def test_cg_multi_per_column_eps_mask_matches_jax():
    """An easy column (b scaled to 1e-8) freezes long before a hard one;
    per-column counts, NaN slots and x equal JAX's."""
    csr = generate_stencil(6, 6, 6)
    _x, b, _xe = cg.init_vectors(csr)
    hard = np.random.default_rng(7).standard_normal(b.shape[0])
    B = np.stack([1e-8 * b, hard], axis=1)
    rj = jax_solve_multi(jax_from_csr("crs", jax_generate(6, 6, 6)), B,
                         itermax=150, eps=1e-6, verbose=False)
    rt = solve_cg_multi(DiaMatrix.from_csr(csr, DTypePolicy.from_names("f64"),
                                           device=CPU),
                        B, itermax=150, eps=1e-6, verbose=False)
    ht = rt.residual_history
    iters = [int(np.sum(~np.isnan(ht[:, c]))) for c in range(2)]
    assert iters[0] < iters[1] < 150
    assert rt.iterations == rj.iterations == iters[1]
    assert_columns_agree(rt, rj, min_entries=2)


def test_cg_multi_sell_permuted_space_matches_jax():
    """SELL without the bslab bridge solves in its permuted row order; x
    comes back in the original order, as in the JAX package."""
    B = rhs_block(generate_stencil(6, 5, 4), 3, seed=3)
    Aj = jax_from_csr("sell", jax_generate(6, 5, 4), C=4, sigma=8,
                      bridge=False)
    At = from_csr("sell", generate_stencil(6, 5, 4),
                  DTypePolicy.from_names("f64"), device=CPU, C=4, sigma=8,
                  bridge=False)
    assert At.permuted_output and Aj.permuted_output
    rj = jax_solve_multi(Aj, B, itermax=40, verbose=False)
    rt = solve_cg_multi(At, B, itermax=40, verbose=False)
    assert rt.iterations == rj.iterations == 40
    assert_columns_agree(rt, rj)


def test_cg_multi_bf16_matches_jax_pallas_path():
    """bf16 vectors with f32 accumulation on bf16 diagonals, against the
    JAX package's Pallas DIA in interpret mode (which also widens X): the
    history to the f32 rule, rtol 1e-4 where normr >= 1e-4 normr0."""
    csr = generate_stencil(6, 6, 6)
    _x, b, xexact = cg.init_vectors(csr, dtype=np.float32)
    B = np.stack([b, 2 * b], axis=1)
    Aj = JaxDia.from_stencil(6, 6, 6, policy=JaxPolicy.from_names("bf16"),
                             impl="pallas_interpret")[0]
    rj = jax_solve_multi(Aj, jnp.asarray(B, jnp.bfloat16), itermax=30,
                         verbose=False)
    rt = solve_cg_multi(carry(Aj), torch.from_numpy(B).to(torch.bfloat16),
                        itermax=30, verbose=False)
    hj, ht = np.asarray(rj.residual_history), rt.residual_history
    for c in range(2):
        sel = hj[:, c] >= 1e-4 * hj[0, c]
        assert sel.sum() >= 5
        np.testing.assert_allclose(ht[sel, c], hj[sel, c], rtol=1e-4)
    assert cg.check_residual(rt.x[:, 1], 2 * xexact) < 0.1


@pytest.mark.parametrize("fmt", ["dia", "crs"])
def test_each_column_is_the_single_rhs_solve(fmt, data_dir):
    """Column c of the blocked solve is the port's single-RHS solve_cg on
    column c: same k and history, x to 1e-13 (the per-column sums of
    the blocked dots may run in another order than the 1-D ones)."""
    csr = read_mm(str(data_dir / "matrix_band_klein.mtx")) if fmt == "dia" \
        else generate_stencil(7, 6, 5)
    A = from_csr(fmt, csr, DTypePolicy.from_names("f64"), device=CPU)
    B = np.random.default_rng(11).standard_normal((csr.nr, 3))
    res = solve_cg_multi(A, B, itermax=40, verbose=False)
    for c in range(3):
        single = cg.solve_cg(A, B[:, c], itermax=40, verbose=False)
        h = res.residual_history[: single.iterations, c]
        np.testing.assert_allclose(h, single.residual_history, rtol=1e-12)
        np.testing.assert_allclose(res.x[:, c], single.x, rtol=0, atol=1e-13)


def test_make_spmm_kn_routes():
    """DIA takes its native spmm_kn; another format stacks its single-vector
    product over the rows."""
    A = DiaMatrix.from_stencil(5, 4, 3, device=CPU)[0]
    assert make_spmm_kn(A) == A.spmm_kn
    B = from_csr("crs", generate_stencil(5, 4, 3),
                 DTypePolicy.from_names("f64"), device=CPU)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 60)))
    Y = make_spmm_kn(B)(X)
    for c in range(2):
        assert torch.equal(Y[c], B.spmv(X[c]))
    with pytest.raises(ValueError, match="nr, k"):
        solve_cg_multi(A, np.ones(60), itermax=3, verbose=False)
