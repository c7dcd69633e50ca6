"""Port parity: the solver family of sparsebench_tpu_torch — GMRES,
Chebyshev, BiCGStab, MINRES, Jacobi and Chebyshev-polynomial PCG (standard
and ``cs``), and the ``sstep`` and ``pipe`` CG variants — against the JAX
package's solvers, on the CPU.

Both packages solve the same matrix (the JAX ``DiaMatrix`` carried over
with ``from_jax_arrays``, or the same host CSR in CRS) from the same numpy
right-hand side; JAX runs its ``xla`` path. Tolerances are ROADMAP's parity
rules: in f64 ``k`` equal and the history to rtol 1e-9 where
normr >= FLOOR normr0, x to 1e-9; in f32 the history to rtol 1e-4 where
normr >= 1e-4 normr0. Below the floor two summation orders give rounding
noise, and the floor is the method's own: 1e-10 for standard and ``cs``
CG, Chebyshev and MINRES on an SPD matrix (which agree to 1e-14 there);
1e-8 for ``pipe`` and GMRES and 1e-6 for ``sstep`` and BiCGStab, whose
recurrences amplify a one-ulp difference in a dot (measured here: pipe
5e-10 at 1e-8 but 2e-7 at 1e-10; sstep 1e-10 at 1e-6 but 9e-8 at 1e-8;
BiCGStab 1e-12 at 1e-6 but 3e-9 at 1e-8); 1e-4 for MINRES on the
indefinite 5^3 matrix, whose Krylov space is exhausted after about 20
steps (1e-11 at 1e-4, 6e-4 at 1e-6; x still agrees to 2e-15). GMRES
compares its per-cycle residuals by the same rule. Chebyshev bounds (a
host eigensolve of a 25-step Lanczos tridiagonal) agree to rtol 1e-12 in
f64.
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats import from_csr as jax_from_csr  # noqa: E402
from sparsebench_tpu.formats.dia import DiaMatrix as JaxDia  # noqa: E402
from sparsebench_tpu.host import HostCSR as JaxCSR  # noqa: E402
from sparsebench_tpu.solvers import bicgstab as jax_bicgstab  # noqa: E402
from sparsebench_tpu.solvers import cg as jax_cg  # noqa: E402
from sparsebench_tpu.solvers import chebyshev as jax_cheb  # noqa: E402
from sparsebench_tpu.solvers import gmres as jax_gmres  # noqa: E402
from sparsebench_tpu.solvers import minres as jax_minres  # noqa: E402
from sparsebench_tpu.solvers import precond as jax_precond  # noqa: E402
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats import from_csr  # noqa: E402
from sparsebench_tpu_torch.formats.dia import DiaMatrix  # noqa: E402
from sparsebench_tpu_torch.host import HostCSR, generate_stencil  # noqa: E402
from sparsebench_tpu_torch.solvers import bicgstab, cg, chebyshev  # noqa: E402
from sparsebench_tpu_torch.solvers import gmres, minres, precond  # noqa: E402

CPU = torch.device("cpu")
FLOOR = {"f64": (1e-10, 1e-9), "f32": (1e-4, 1e-4)}
# the f64 noise floor of each method (module docstring)
METHOD_FLOOR = {"standard": 1e-10, "cs": 1e-10, "pipe": 1e-8, "sstep": 1e-6,
                "gmres": 1e-8, "bicgstab": 1e-6, "minres-indefinite": 1e-4}
NP_DT = {"f64": np.float64, "f32": np.float32}


def carry(Aj):
    return DiaMatrix.from_jax_arrays(
        np.asarray(Aj.data), Aj.offsets, Aj.nr, Aj.nc, Aj.nnz, Aj.nr_pad,
        Aj.start_row, Aj.total_nr, Aj.total_nnz, device=CPU, impl="torch",
    )


def stencil(dtype="f64", dims=(10, 9, 7)):
    """(JAX DIA, port DIA, b, xexact, 1/diag) of the generated problem."""
    Aj, counts = JaxDia.from_stencil(*dims,
                                     policy=JaxPolicy.from_names(dtype),
                                     impl="xla")
    _x, b, xexact = jax_cg.init_vectors(dtype=NP_DT[dtype],
                                        row_lengths=np.asarray(counts))
    return Aj, carry(Aj), b, xexact, np.full(Aj.nr, 1.0 / 27.0)


def csr_pair(row_ptr, col, val, n):
    return (JaxCSR(row_ptr=row_ptr, col=col, val=val, nr=n, nc=n),
            HostCSR(row_ptr=row_ptr, col=col, val=val, nr=n, nc=n))


def nonsymmetric(dims=(8, 7, 6), seed=0):
    """The stencil with its strictly upper part scaled by 1.3 and a seeded
    +-10 % jitter: non-symmetric, diagonally dominant. (JAX CRS, port CRS,
    b, 1/diag)."""
    c = generate_stencil(*dims)
    rows = np.repeat(np.arange(c.nr), c.row_lengths)
    jitter = np.random.default_rng(seed).uniform(0.9, 1.1, c.nnz)
    val = np.where(c.col > rows, 1.3 * c.val, c.val) * jitter
    jc, tc = csr_pair(c.row_ptr, c.col, val, c.nr)
    b = np.random.default_rng(seed + 1).standard_normal(c.nr)
    return (jax_from_csr("crs", jc),
            from_csr("crs", tc, DTypePolicy.from_names("f64"), device=CPU),
            b, 1.0 / tc.diagonal())


def indefinite(dims=(5, 5, 5), shift=31.41):
    """Symmetric indefinite: the stencil shifted by -shift I (tests/
    test_minres.py's matrix). (JAX CRS, port CRS, b)."""
    c = generate_stencil(*dims)
    rows = np.repeat(np.arange(c.nr), c.row_lengths)
    val = c.val - np.where(c.col == rows, shift, 0.0)
    jc, tc = csr_pair(c.row_ptr, c.col, val, c.nr)
    b = np.random.default_rng(2).standard_normal(c.nr)
    return (jax_from_csr("crs", jc),
            from_csr("crs", tc, DTypePolicy.from_names("f64"), device=CPU), b)


def assert_histories_agree(ht, hj, dtype="f64", min_entries=3, floor=None):
    floor, rtol = (floor or FLOOR[dtype][0]), FLOOR[dtype][1]
    hj = np.asarray(hj)
    below = np.flatnonzero(~(hj >= floor * hj[0]))
    n = int(below[0]) if below.size else hj.size
    assert n >= min_entries and ht.size >= n
    np.testing.assert_allclose(ht[:n], hj[:n], rtol=rtol)


def assert_same_solve(rt, rj, dtype="f64", atol=1e-9, floor=None):
    if dtype == "f64":
        assert rt.iterations == rj.iterations
    assert_histories_agree(rt.residual_history, rj.residual_history, dtype,
                           floor=floor)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=atol)


# -- GMRES -----------------------------------------------------------------


@pytest.mark.parametrize("orth", ["cgs", "cgs2"])
@pytest.mark.parametrize("restart", [8, 12])
def test_gmres_nonsymmetric_matches_jax(orth, restart):
    Aj, At, b, _inv = nonsymmetric()
    kw = dict(itermax=40, restart=restart, orth=orth, verbose=False)
    rj = jax_gmres.solve_gmres(Aj, b, **kw)
    rt = gmres.solve_gmres(At, b, **kw)
    assert rt.iterations == rj.iterations
    assert not rt.breakdown and not rj.breakdown
    h0 = np.linalg.norm(b)
    sel = np.asarray(rj.residual_history) >= METHOD_FLOOR["gmres"] * h0
    assert sel.sum() >= 1 and rt.residual_history.size == \
        rj.residual_history.size
    np.testing.assert_allclose(rt.residual_history[sel],
                               rj.residual_history[sel], rtol=1e-9)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)


@pytest.mark.parametrize("precond_kind", ["jacobi", "cheb"])
def test_gmres_preconditioned_and_eps_exit_match_jax(precond_kind):
    """Right preconditioning; eps mid-cycle: the exact inner count."""
    Aj, At, b, xexact, inv = stencil()
    kw = dict(itermax=60, restart=12, eps=1e-6, verbose=False)
    if precond_kind == "jacobi":
        pj = pt = None
        kw["inv_diag"] = inv
    else:
        pj = jax_precond.ChebPrecond(0.8, 40.0, 2)
        pt = precond.ChebPrecond.from_jax(pj)
    rj = jax_gmres.solve_gmres(Aj, b, precond=pj, **kw)
    rt = gmres.solve_gmres(At, b, precond=pt, **kw)
    assert rt.iterations == rj.iterations < 60
    hj = np.asarray(rj.residual_history)
    sel = hj >= METHOD_FLOOR["gmres"] * np.linalg.norm(b)
    assert sel.sum() >= 1 and rt.residual_history.size == hj.size
    np.testing.assert_allclose(rt.residual_history[sel], hj[sel], rtol=1e-9)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)


def test_gmres_breakdown_flag_carries_over():
    """A singular system (rank 1, b outside the range): both flag the
    breakdown and keep the last good iterate (tests/test_solvers_extra.py's
    case)."""
    row_ptr = np.array([0, 2, 4], dtype=np.int64)
    col = np.array([0, 1, 0, 1], dtype=np.int64)
    jc, tc = csr_pair(row_ptr, col, np.ones(4), 2)
    b = np.array([1.0, -1.0])
    kw = dict(itermax=10, eps=1e-14, restart=5, verbose=False)
    rj = jax_gmres.solve_gmres(jax_from_csr("crs", jc), b, **kw)
    rt = gmres.solve_gmres(
        from_csr("crs", tc, DTypePolicy.from_names("f64"), device=CPU), b,
        **kw)
    assert rt.breakdown and rj.breakdown
    assert rt.iterations == rj.iterations
    np.testing.assert_array_equal(rt.x, np.asarray(rj.x))
    with pytest.raises(ValueError, match="orth"):
        gmres.solve_gmres(tc_dia(), b, orth="mgs")


def tc_dia():
    return DiaMatrix.from_stencil(2, 2, 2, device=CPU)[0]


def test_gmres_f32_matches_jax():
    Aj, At, b, _xe, _inv = stencil("f32")
    b = np.ones(Aj.nr, np.float32)
    kw = dict(itermax=40, restart=3, verbose=False)
    rj = jax_gmres.solve_gmres(Aj, b, **kw)
    rt = gmres.solve_gmres(At, b, **kw)
    sel = np.asarray(rj.residual_history) >= 1e-4 * np.linalg.norm(b)
    assert sel.sum() >= 2
    np.testing.assert_allclose(rt.residual_history[sel],
                               rj.residual_history[sel], rtol=1e-4)


# -- Chebyshev -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["solver", "precond"])
@pytest.mark.parametrize("jacobi", [False, True])
def test_chebyshev_bounds_match_jax(mode, jacobi):
    Aj, At, _b, _xe, inv = stencil()
    inv = inv if jacobi else None
    lj = jax_cheb.estimate_bounds(Aj, Aj.nr, np.float64, inv_diag=inv,
                                  mode=mode)
    lt = chebyshev.estimate_bounds(At, At.nr, torch.float64, inv_diag=inv,
                                   mode=mode)
    np.testing.assert_allclose(lt, lj, rtol=1e-12)


@pytest.mark.parametrize("jacobi", [False, True])
def test_chebyshev_solver_matches_jax(jacobi):
    Aj, At, b, xexact, inv = stencil()
    kw = dict(itermax=80, verbose=False,
              inv_diag=inv if jacobi else None)
    rj = jax_cheb.solve_chebyshev(Aj, b, **kw)
    rt = chebyshev.solve_chebyshev(At, b, **kw)
    np.testing.assert_allclose(rt.bounds, rj.bounds, rtol=1e-12)
    assert_same_solve(rt, rj)
    assert cg.check_residual(rt.x, xexact) < 1e-4


def test_chebyshev_eps_and_sell_permuted_match_jax():
    """eps stops the masked loop where the JAX while_loop stops; SELL
    without its bridge runs in permuted space."""
    c = generate_stencil(6, 5, 4)
    _x, b, _xe = cg.init_vectors(c)
    jc, tc = csr_pair(c.row_ptr, c.col, c.val, c.nr)
    Aj = jax_from_csr("sell", jc, C=4, sigma=8, bridge=False)
    At = from_csr("sell", tc, DTypePolicy.from_names("f64"), device=CPU, C=4,
                  sigma=8, bridge=False)
    rj = jax_cheb.solve_chebyshev(Aj, b, itermax=150, eps=1e-8,
                                  verbose=False)
    rt = chebyshev.solve_chebyshev(At, b, itermax=150, eps=1e-8,
                                   verbose=False)
    assert rt.iterations == rj.iterations < 150
    assert_same_solve(rt, rj)


# -- BiCGStab and MINRES -------------------------------------------------------


@pytest.mark.parametrize("precond_kind", [None, "jacobi", "cheb"])
def test_bicgstab_nonsymmetric_matches_jax(precond_kind):
    Aj, At, b, inv = nonsymmetric()
    kw = dict(itermax=30, verbose=False)
    pj = pt = None
    if precond_kind == "jacobi":
        kw["inv_diag"] = inv
    elif precond_kind == "cheb":
        pj = jax_precond.ChebPrecond(0.5, 45.0, 2)
        pt = precond.ChebPrecond.from_jax(pj)
    rj = jax_bicgstab.solve_bicgstab(Aj, b, precond=pj, **kw)
    rt = bicgstab.solve_bicgstab(At, b, precond=pt, **kw)
    assert_same_solve(rt, rj, floor=METHOD_FLOOR["bicgstab"])


def test_bicgstab_stencil_f32_matches_jax():
    Aj, At, b, xexact, _inv = stencil("f32")
    rj = jax_bicgstab.solve_bicgstab(Aj, b, itermax=40, verbose=False)
    rt = bicgstab.solve_bicgstab(At, b, itermax=40, verbose=False)
    assert_same_solve(rt, rj, "f32", atol=1e-4)


@pytest.mark.parametrize("case", ["spd", "spd-jacobi", "indefinite"])
def test_minres_matches_jax(case):
    floor = None
    if case == "indefinite":
        Aj, At, b = indefinite()
        kw = {}
        floor = METHOD_FLOOR["minres-indefinite"]
    else:
        Aj, At, b, _xe, inv = stencil()
        kw = {"inv_diag": inv} if case == "spd-jacobi" else {}
    rj = jax_minres.solve_minres(Aj, b, itermax=60, verbose=False, **kw)
    rt = minres.solve_minres(At, b, itermax=60, verbose=False, **kw)
    assert_same_solve(rt, rj, floor=floor)


def test_minres_refuses_a_non_positive_diagonal():
    Aj, At, b = indefinite()
    with pytest.raises(ValueError, match="positive"):
        minres.solve_minres(At, b, inv_diag=-np.ones(At.nr), verbose=False)


# -- preconditioned CG and the sstep / pipe variants -----------------------


def pcg_case(kind):
    """(inv_diag, JAX precond, port precond) for ``kind``; the polynomial
    bounds from the JAX estimator, carried over with from_jax."""
    Aj, At, b, xexact, inv = stencil()
    inv_d = inv if kind in ("jacobi", "cheb-jacobi") else None
    pj = pt = None
    if kind in ("cheb", "cheb-jacobi"):
        pj = jax_precond.cheb_precond_for(Aj, Aj.nr, np.float64, degree=3,
                                          inv_diag=inv_d)
        pt = precond.ChebPrecond.from_jax(pj)
    return Aj, At, b, xexact, inv_d, pj, pt


@pytest.mark.parametrize("variant", ["standard", "cs", "pipe"])
@pytest.mark.parametrize("kind", ["jacobi", "cheb", "cheb-jacobi"])
def test_pcg_matches_jax(variant, kind):
    Aj, At, b, xexact, inv_d, pj, pt = pcg_case(kind)
    kw = dict(itermax=50, inv_diag=inv_d, variant=variant, verbose=False)
    rj = jax_cg.solve_cg(Aj, b, precond=pj, **kw)
    rt = cg.solve_cg(At, b, precond=pt, **kw)
    assert_same_solve(rt, rj, floor=METHOD_FLOOR[variant])
    assert cg.check_residual(rt.x, xexact) < 1e-9


def test_cheb_precond_for_matches_jax():
    """The port's own estimate of the preconditioner's bounds equals the
    JAX package's."""
    Aj, At, _b, _xe, inv = stencil()
    for inv_d in (None, inv):
        pj = jax_precond.cheb_precond_for(Aj, Aj.nr, np.float64, degree=4,
                                          inv_diag=inv_d)
        pt = precond.cheb_precond_for(At, At.nr, torch.float64, degree=4,
                                      inv_diag=inv_d)
        np.testing.assert_allclose([pt.lmin, pt.lmax], [pj.lmin, pj.lmax],
                                   rtol=1e-12)
        assert pt.degree == pj.degree == 4
    with pytest.raises(ValueError, match="degree"):
        precond.ChebPrecond(1.0, 2.0, 0)
    with pytest.raises(ValueError, match="lmin"):
        precond.ChebPrecond(2.0, 1.0)


@pytest.mark.parametrize("variant,kw", [
    ("sstep", {"sstep": 4}), ("sstep", {"sstep": 2}), ("pipe", {}),
])
@pytest.mark.parametrize("jacobi", [False, True])
def test_sstep_and_pipe_match_jax(variant, kw, jacobi):
    Aj, At, b, xexact, inv = stencil()
    args = dict(itermax=60, variant=variant, verbose=False,
                inv_diag=inv if jacobi else None, **kw)
    rj = jax_cg.solve_cg(Aj, b, **args)
    rt = cg.solve_cg(At, b, **args)
    ht, hj = rt.residual_history, np.asarray(rj.residual_history)
    assert rt.iterations == rj.iterations
    # sstep leaves NaN slots between outer steps: compare where JAX has one
    np.testing.assert_array_equal(np.isnan(ht), np.isnan(hj))
    ok = ~np.isnan(hj)
    assert_histories_agree(ht[ok], hj[ok], min_entries=3,
                           floor=METHOD_FLOOR[variant])
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)


def test_pipe_replacement_fires_and_matches_jax(monkeypatch):
    """f32 at 16^3 past its floor: the drift trigger replaces the residual
    (the branch read on the host), and both packages reach the same x
    accuracy. The history agrees to the f32 rtol 1e-4 down to 1e-2 of its
    start: in f32 the pipelined recurrence's amplified rounding reaches
    1e-4 of the value at 5e-3 of the start."""
    from sparsebench_tpu_torch.solvers import cg_pipe

    reads = []
    flags = cg_pipe._flags

    def spy(go, need_rep):
        out = list(flags(go, need_rep))
        reads.append(out[1])
        return iter(out)

    monkeypatch.setattr(cg_pipe, "_flags", spy)
    Aj, At, b, xexact, _inv = stencil("f32", (16, 16, 16))
    rj = jax_cg.solve_cg(Aj, b, itermax=150, variant="pipe", verbose=False)
    rt = cg.solve_cg(At, b, itermax=150, variant="pipe", verbose=False)
    assert any(reads)  # a replacement ran
    assert_histories_agree(rt.residual_history, rj.residual_history, "f32",
                           floor=1e-2)
    assert cg.check_residual(rt.x, xexact) < 1e-5
    assert cg.check_residual(np.asarray(rj.x), xexact) < 1e-5


def test_precond_refusals_match_jax():
    _Aj, At, b, _xe, inv = stencil()
    pc = precond.ChebPrecond(1.0, 30.0, 2)
    for variant in ("sstep", "fused", "vmem"):
        with pytest.raises(ValueError, match="'standard', 'cs' and 'pipe'"):
            cg.solve_cg(At, b, itermax=5, precond=pc, variant=variant,
                        verbose=False)
    with pytest.raises(ValueError, match="unpreconditioned"):
        cg.solve_cg(At, b, itermax=5, inv_diag=inv, variant="fused",
                    verbose=False)
