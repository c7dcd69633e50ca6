"""Port parity: the matrix-free stencil operator and its kernels' plain
versions (sparsebench_tpu_torch formats/stencil.py, ops/stencil.py,
ops/cg_fused.py, ops/stencil_cg_vmem.py) against the JAX package, on the
CPU.

The same numpy-seeded inputs go through both. The JAX side runs its XLA
form (``impl="xla"``) and its Pallas kernels in interpret mode
(``impl="pallas"``, ``interpret=True``), which work in a padded vector
space; they are compared in the natural row order through JAX's own
``permute_vector``/``unpermute_vector``. The port's operator is built from
the JAX operator's static fields (it holds no arrays).

Tolerances. The two sum the stencil in different orders (JAX's Pallas form
applies Sz first, the port Sx first), so an apply agrees to a bound
relative to (|A||x|)_i: 1e-13 in f64, 28 eps in f32 (a 27-term sum). Dots
over n terms agree to n eps relative to the sum of |terms|. The vmem CG
history agrees to rtol 1e-9 above 1e-10 of its start (ROADMAP's f64 parity
rule), and k is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats import stencil as jax_stencil  # noqa: E402
from sparsebench_tpu.ops.cg_fused import cs_update_pallas  # noqa: E402
from sparsebench_tpu.ops.stencil_cg_vmem import (  # noqa: E402
    stencil_cg_vmem_pallas,
)
from sparsebench_tpu.ops.stencil_pallas import pad_dims  # noqa: E402
from sparsebench_tpu_torch.formats.stencil import (  # noqa: E402
    StencilOperator,
    stencil_row_counts,
)
from sparsebench_tpu_torch.ops.cg_fused import cs_update_torch  # noqa: E402
from sparsebench_tpu_torch.ops.stencil import (  # noqa: E402
    stencil_apply_dots_torch,
    stencil_apply_torch,
)
from sparsebench_tpu_torch.ops.stencil_cg_vmem import (  # noqa: E402
    stencil_cg_vmem_torch,
)

CPU = torch.device("cpu")
NP_DT = {"f64": np.float64, "f32": np.float32}
EPS = {"f64": np.finfo(np.float64).eps, "f32": np.finfo(np.float32).eps}
APPLY_TOL = {"f64": 1e-13, "f32": 28 * EPS["f32"]}

# (dims, use_7pt): asymmetric, 7-point, a single point, nx past one and
# exactly one 128-lane group (JAX pads one extra lane group there); then
# the edge shapes of the kernels' tile march (chip_smoke.py phase 3b): nx
# past one 32-column tile, ny past one tile of rows, a two-point cube
ODD_CASES = [((37, 29, 23), False), ((37, 29, 23), True), ((64, 8, 3), False),
             ((64, 8, 3), True), ((2, 2, 2), False), ((2, 2, 2), True)]
APPLY_CASES = [((10, 9, 7), False), ((8, 8, 8), True), ((1, 1, 1), False),
               ((130, 2, 3), False), ((128, 5, 4), False)] + ODD_CASES


def jax_op(dims, use_7pt, dtype, impl):
    return jax_stencil.StencilOperator.from_stencil(
        *dims, use_7pt=use_7pt, policy=JaxPolicy.from_names(dtype, "i32"),
        impl=impl)[0]


def port_op(Aj):
    """The port's operator from the JAX operator's static fields."""
    return StencilOperator.from_stencil(Aj.nx, Aj.ny, Aj.nz,
                                        use_7pt=Aj.use_7pt, device=CPU)[0]


def abs_ax(A, v):
    """(|A| |v|)_i in f64: 54|v| - A|v| for both stencils (the diagonal is
    27, every neighbour -1)."""
    a = torch.from_numpy(np.abs(np.asarray(v, np.float64)))
    return (54 * a - A.spmv(a)).numpy()


def assert_apply_close(got, want, bound, dtype):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.isfinite(got).all()
    assert (err <= APPLY_TOL[dtype] * bound + 1e-300).all(), err.max()


@pytest.mark.parametrize("dims", [(10, 9, 7), (8, 8, 8), (1, 1, 1),
                                  (130, 2, 3), (128, 5, 4), (1, 5, 6),
                                  (2, 2, 2)])
@pytest.mark.parametrize("use_7pt", [False, True])
def test_row_counts_equal_jax(dims, use_7pt):
    np.testing.assert_array_equal(
        stencil_row_counts(*dims, use_7pt),
        jax_stencil.stencil_row_counts(*dims, use_7pt))
    Aj = jax_op(dims, use_7pt, "f64", "xla")
    A = port_op(Aj)
    assert (A.nr, A.nc, A.nnz, A.total_nr, A.total_nnz) == (
        Aj.nr, Aj.nr, Aj.nnz, Aj.total_nr, Aj.total_nnz)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", APPLY_CASES)
def test_apply_matches_jax(case, dtype, impl):
    dims, use_7pt = case
    Aj = jax_op(dims, use_7pt, dtype, impl)
    A = port_op(Aj)
    x = np.random.default_rng(3).standard_normal(A.nr).astype(NP_DT[dtype])
    want = np.asarray(Aj.spmv(jnp.asarray(x)))  # pallas: pad, apply, unpad
    got = A.spmv(torch.from_numpy(x)).numpy()
    assert got.dtype == x.dtype
    assert_apply_close(got, want, abs_ax(A, x), dtype)


@pytest.mark.parametrize("case", [APPLY_CASES[0], APPLY_CASES[1],
                                  APPLY_CASES[4]] + ODD_CASES)
def test_apply_dots_match_jax(case):
    """K2's dots form: [x.x, (Ax).x] in f32, against the Pallas kernel's
    per-tile partials summed (interpret mode)."""
    dims, use_7pt = case
    Aj = jax_op(dims, use_7pt, "f32", "pallas")
    A = port_op(Aj)
    x = np.random.default_rng(4).standard_normal(A.nr).astype(np.float32)
    wj, gdj = Aj.spmv_permuted_dots(Aj.permute_vector(jnp.asarray(x)))
    w, gd = A.spmv_permuted_dots(torch.from_numpy(x))
    assert gd.dtype == torch.float32 and gd.shape == (2,)
    assert_apply_close(w.numpy(), np.asarray(Aj.unpermute_vector(wj)),
                       abs_ax(A, x), "f32")
    wf = w.numpy().astype(np.float64)
    scale = np.array([np.sum(x.astype(np.float64) ** 2),
                      np.sum(np.abs(wf * x))])
    np.testing.assert_array_less(np.abs(gd.numpy() - np.asarray(gdj)),
                                 A.nr * EPS["f32"] * scale + 1e-30)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("case", [APPLY_CASES[0], APPLY_CASES[1],
                                  APPLY_CASES[3]] + ODD_CASES)
def test_axpy_spmv_dots_matches_jax(case, dtype):
    """K3's plain version: p' = r + beta p, w = A p', delta = p'.w (delta at
    the vectors' width), against the Pallas kernel in interpret mode."""
    dims, use_7pt = case
    Aj = jax_op(dims, use_7pt, dtype, "pallas")
    A = port_op(Aj)
    rng = np.random.default_rng(5)
    r, p = (rng.standard_normal(A.nr).astype(NP_DT[dtype]) for _ in range(2))
    beta = float(rng.uniform(0.1, 2.0))
    pnj, wj, dj = Aj.axpy_spmv_dots(Aj.permute_vector(jnp.asarray(r)),
                                    Aj.permute_vector(jnp.asarray(p)),
                                    jnp.asarray(beta))
    pn, w, d = A.axpy_spmv_dots(torch.from_numpy(r), torch.from_numpy(p),
                                torch.tensor(beta, dtype=torch.float64))
    assert pn.dtype == w.dtype == d.dtype == torch.from_numpy(r).dtype
    pn_want = np.asarray(Aj.unpermute_vector(pnj))
    np.testing.assert_allclose(pn.numpy(), pn_want, rtol=2 * EPS[dtype],
                               atol=4 * EPS[dtype] * np.abs(pn_want).max())
    assert_apply_close(w.numpy(), np.asarray(Aj.unpermute_vector(wj)),
                       abs_ax(A, pn.numpy()), dtype)
    scale = np.sum(np.abs(w.numpy().astype(np.float64) * pn.numpy()))
    assert abs(float(d) - float(dj)) <= 2 * A.nr * EPS[dtype] * scale


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cs_update_matches_jax(dtype):
    """K4's plain version against cs_update_pallas (interpret) at length
    8192: alpha and beta rounded to f32 by both. The JAX interpreter may
    contract a product and a sum into one rounding; the port rounds each,
    so the two differ by at most a few ulps of the operands."""
    rng = np.random.default_rng(2)
    n = 8192
    vecs = [rng.standard_normal(n).astype(NP_DT[dtype]) for _ in range(6)]
    al, be = 0.37, -1.25
    want = cs_update_pallas(*map(jnp.asarray, vecs), jnp.float32(al),
                            jnp.float32(be), interpret=True)
    got = cs_update_torch(*map(torch.from_numpy, vecs), torch.tensor(al),
                          torch.tensor(be))
    tol = 4 * EPS[dtype]
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.from_numpy(vecs[0]).dtype
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol * 4)
    # the port's own arithmetic, op by op
    u, p, w_, s, x, r = vecs
    a, b = (np.asarray(np.float32(v), NP_DT[dtype]) for v in (al, be))
    pe, se = u + b * p, w_ + b * s
    for g, e in zip(got, (pe, se, x + a * pe, r - a * se)):
        np.testing.assert_array_equal(g.numpy(), e)


def vmem_inputs(dims, use_7pt, x0):
    """(JAX operator, port operator, r0 = b - A x0, x0) in f64."""
    Aj = jax_op(dims, use_7pt, "f64", "pallas")
    A = port_op(Aj)
    b = 27.0 - (stencil_row_counts(*dims, use_7pt) - 1.0)
    r0 = b - A.spmv(torch.from_numpy(x0)).numpy()
    return Aj, A, r0, x0


def run_vmem_both(Aj, A, r0, x0, eps, itermax):
    nxp, nyp = pad_dims(A.nx, A.ny, A.nz)
    rows = (A.nz + 2) * nyp
    xj, hj = stencil_cg_vmem_pallas(
        Aj.permute_vector(jnp.asarray(r0)).reshape(rows, nxp),
        Aj.permute_vector(jnp.asarray(x0)).reshape(rows, nxp),
        jnp.asarray(eps, jnp.float64), A.nx, A.ny, A.nz, itermax,
        use_7pt=A.use_7pt, interpret=True)
    xj = np.asarray(Aj.unpermute_vector(xj.reshape(-1)))
    x, h = stencil_cg_vmem_torch(torch.from_numpy(r0), torch.from_numpy(x0),
                                 eps, A.nx, A.ny, A.nz, itermax, A.use_7pt)
    return (x.numpy(), h.numpy()), (xj, np.asarray(hj))


def assert_vmem_agree(port, jx):
    (x, h), (xj, hj) = port, jx
    assert h.shape == hj.shape
    k, kj = int(np.sum(~np.isnan(h))), int(np.sum(~np.isnan(hj)))
    assert k == kj
    assert np.isnan(h[k:]).all()
    sel = hj[:k] >= 1e-10 * hj[0]
    assert sel.sum() >= 5
    np.testing.assert_allclose(h[:k][sel], hj[:k][sel], rtol=1e-9)
    np.testing.assert_allclose(x, xj, rtol=0, atol=1e-10)
    return k


def test_vmem_cg_matches_jax():
    dims = (10, 9, 8)
    Aj, A, r0, x0 = vmem_inputs(dims, False, np.zeros(720))
    k = assert_vmem_agree(*run_vmem_both(Aj, A, r0, x0, 0.0, 25))
    assert k == 25


def test_vmem_cg_7pt_eps_exit_and_x0_match_jax():
    """The lagged exit test and a nonzero x0 (JAX tests/test_cg.py
    test_cg_vmem_variant_7pt_eps_exit_and_x0)."""
    x0 = np.random.default_rng(2).standard_normal(512) * 0.1
    Aj, A, r0, x0 = vmem_inputs((8, 8, 8), True, x0)
    k = assert_vmem_agree(*run_vmem_both(Aj, A, r0, x0, 1e-8, 40))
    assert k < 40


def test_plain_apply_order_is_sx_first():
    """The port's one summation order, stated: Sx, then Sy, then Sz, each
    ((left + centre) + right), and y = 28 x - S."""
    rng = np.random.default_rng(8)
    nx, ny, nz = 5, 4, 3
    x = rng.standard_normal(nx * ny * nz).astype(np.float32)
    v = x.reshape(nz, ny, nx)

    def s3(a, ax):
        p = np.pad(a, [(1, 1) if i == ax else (0, 0) for i in range(3)])
        n = a.shape[ax]
        return (np.take(p, range(n), ax) + np.take(p, range(1, n + 1), ax)) \
            + np.take(p, range(2, n + 2), ax)

    want = (np.float32(28) * v - s3(s3(s3(v, 2), 1), 0)).reshape(-1)
    got = stencil_apply_torch(torch.from_numpy(x), nx, ny, nz).numpy()
    np.testing.assert_array_equal(got, want)
    y, gd = stencil_apply_dots_torch(torch.from_numpy(x), nx, ny, nz)
    np.testing.assert_array_equal(y.numpy(), want)
    np.testing.assert_allclose(gd.numpy(), [np.sum(x * x), np.sum(want * x)],
                               rtol=1e-5)
