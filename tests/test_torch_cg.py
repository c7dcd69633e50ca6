"""Port parity: standard CG of sparsebench_tpu_torch against the JAX
package's ``solve_cg``, on the CPU.

Both solve the same matrix (the JAX DiaMatrix carried over with
``from_jax_arrays``) from the same numpy right-hand side; JAX runs its
``xla`` SpMV path. Tolerances: ``k`` is equal; history entries above the
rounding-noise floor agree. In f64 the floor is 1e-10 of the initial
residual and the entries above it agree to rtol 1e-9 (at 16^3 the history
falls to 1.8e-13 of its start by iteration 30 and to 1e-64 by 149; below
about 1e-10 it is rounding noise, where no two summation orders agree); in
f32 the floor is 1e-4 and the rtol 1e-4, and ``k`` is not compared: f32
reaches machine zero here and the breakdown step falls in the noise.
max|x - xexact| agrees to 1e-10 (f64).
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats.dia import DiaMatrix as JaxDia  # noqa: E402
from sparsebench_tpu.host import HostCSR, read_mm  # noqa: E402
from sparsebench_tpu.solvers import cg as jax_cg  # noqa: E402
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats.dia import DiaMatrix  # noqa: E402
from sparsebench_tpu_torch.ops.blas1 import ddot, waxpby  # noqa: E402
from sparsebench_tpu_torch.solvers import cg  # noqa: E402

CPU = torch.device("cpu")
FLOOR = {"f64": (1e-10, 1e-9), "f32": (1e-4, 1e-4)}
NP_DT = {"f64": np.float64, "f32": np.float32}


def carry(Aj):
    return DiaMatrix.from_jax_arrays(
        np.asarray(Aj.data), Aj.offsets, Aj.nr, Aj.nc, Aj.nnz, Aj.nr_pad,
        Aj.start_row, Aj.total_nr, Aj.total_nnz, device=CPU, impl="torch",
    )


def problem(case, dtype, data_dir):
    """(JAX matrix, b, xexact or None) for a named case."""
    jp = JaxPolicy.from_names(dtype, "i32")
    if case.startswith("klein"):
        csr = HostCSR.from_coo(
            read_mm(str(data_dir / "matrix_band_klein.mtx")))
        Aj = JaxDia.from_csr(csr, jp, impl="xla")
        if case == "klein":
            b = np.ones(csr.nr, NP_DT[dtype])  # reference b = 1
        else:
            b = np.random.default_rng(5).standard_normal(csr.nr).astype(
                NP_DT[dtype])
        return Aj, b, None
    dims = {"16^3": (16, 16, 16), "10x9x7": (10, 9, 7)}[case]
    Aj, counts = JaxDia.from_stencil(*dims, policy=jp, impl="xla")
    _x, b, xexact = jax_cg.init_vectors(
        dtype=NP_DT[dtype], row_lengths=np.asarray(counts))
    return Aj, b, xexact


def assert_histories_agree(ht, hj, dtype):
    """The histories agree up to where JAX's first falls below the floor;
    both solves get at least that far."""
    floor, rtol = FLOOR[dtype]
    below = np.flatnonzero(hj < floor * hj[0])
    n = int(below[0]) if below.size else hj.size
    assert n >= 2 and ht.size >= n
    np.testing.assert_allclose(ht[:n], hj[:n], rtol=rtol)


@pytest.mark.parametrize("case", ["16^3", "10x9x7", "klein", "klein-rand"])
def test_cg_f64_matches_jax(case, data_dir):
    Aj, b, xexact = problem(case, "f64", data_dir)
    rj = jax_cg.solve_cg(Aj, b, itermax=150, verbose=False)
    rt = cg.solve_cg(carry(Aj), b, itermax=150, verbose=False)
    assert rt.iterations == rj.iterations
    assert_histories_agree(rt.residual_history, rj.residual_history, "f64")
    if xexact is not None:
        assert abs(cg.check_residual(rt.x, xexact)
                   - jax_cg.check_residual(rj.x, xexact)) <= 1e-10
    else:
        np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    if case == "klein":
        # A @ 1 = 1: exact after one step, then breakdown (p.Ap = 0) ends
        # the solve with x frozen
        assert rt.iterations == 3
        np.testing.assert_array_equal(rt.x, np.ones_like(rt.x))


@pytest.mark.parametrize("case", ["16^3", "10x9x7"])
def test_cg_f32_matches_jax(case, data_dir):
    Aj, b, xexact = problem(case, "f32", data_dir)
    rj = jax_cg.solve_cg(Aj, b, itermax=150, verbose=False)
    rt = cg.solve_cg(carry(Aj), b, itermax=150, verbose=False)
    # no equal k here: at these sizes f32 reaches machine zero and the
    # breakdown step falls in the rounding noise below the floor
    assert rt.x.dtype == np.float32
    assert_histories_agree(rt.residual_history, rj.residual_history, "f32")
    assert cg.check_residual(rt.x, xexact) < 1e-5


@pytest.mark.parametrize("eps", [1e-3, 1e-8])
def test_cg_eps_exit_matches_jax(eps, data_dir):
    """eps > 0: the masked loop stops k where JAX's while_loop does (the
    exit test reads the previous body's normr)."""
    Aj, b, _ = problem("16^3", "f64", data_dir)
    rj = jax_cg.solve_cg(Aj, b, itermax=150, eps=eps, verbose=False)
    rt = cg.solve_cg(carry(Aj), b, itermax=150, eps=eps, verbose=False)
    assert rt.iterations == rj.iterations < 150
    assert_histories_agree(rt.residual_history, rj.residual_history, "f64")
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)


def test_cg_breakdown_matches_jax():
    """2*I with b = 1: exact after one step; the second body finds
    p.Ap = 0 <= rtrans*1e-30, sets alpha = 0 and ends the solve at k = 3
    with x = 0.5 and the history NaN beyond."""
    n = 300
    csr = HostCSR(row_ptr=np.arange(n + 1), col=np.arange(n),
                  val=np.full(n, 2.0), nr=n, nc=n)
    Aj = JaxDia.from_csr(csr, JaxPolicy.from_names("f64", "i32"), impl="xla")
    b = np.ones(n)
    rj = jax_cg.solve_cg(Aj, b, itermax=20, verbose=False)
    At = DiaMatrix.from_csr(csr, DTypePolicy.from_names("f64"), device=CPU)
    state = cg.cg_init(At, torch.from_numpy(b), torch.zeros(n), 20)
    k, x, _p, _r, _rt, _nr, hist, done = cg.cg_run(At, state, 20, 0.0)
    assert int(k) == rj.iterations == 3
    assert bool(done)
    np.testing.assert_array_equal(x.numpy(), np.full(n, 0.5))
    np.testing.assert_array_equal(hist.numpy()[:3], rj.residual_history)
    assert np.isnan(hist.numpy()[3:]).all()


def test_cg_run_segments_equal_one_run():
    """Two cg_run segments give the bits of one run: the masked loop keeps
    every state entry (p included) frozen once inactive."""
    A, counts = DiaMatrix.from_stencil(8, 7, 6, device=CPU)
    _x, b, _xe = cg.init_vectors(row_lengths=counts)
    b = torch.from_numpy(b)
    x0 = torch.zeros_like(b)
    one = cg.cg_run(A, cg.cg_init(A, b, x0, 60), 60, 0.0)
    half = cg.cg_run(A, cg.cg_init(A, b, x0, 60), 25, 0.0)
    assert int(half[0]) == 25
    two = cg.cg_run(A, half, 60, 0.0)
    for a, c in zip(one, two):
        assert torch.equal(a, c)


def test_cg_bf16_vectors_accumulate_in_f32():
    A, counts = DiaMatrix.from_stencil(8, 8, 8, device=CPU,
                                       policy=DTypePolicy.from_names("bf16"))
    assert A.data.dtype == torch.bfloat16
    _x, b, _xe = cg.init_vectors(dtype=np.float32, row_lengths=counts)
    res = cg.solve_cg(A, torch.from_numpy(b).to(torch.bfloat16), itermax=20,
                      verbose=False)
    assert res.iterations == 20
    assert res.residual_history.dtype == np.float32
    assert np.isfinite(res.residual_history).all()
    assert res.residual_history[-1] < res.residual_history[0]


def test_print_residual_history_matches_jax(capsys):
    hist = np.array([3.0, 2.0, np.nan, 1.0e-3, 5e-9, 1e-12, 2.5e-15, 1e-16,
                     np.nan, np.nan])
    jax_cg.print_residual_history(hist, 8, 10)
    want = capsys.readouterr().out
    cg.print_residual_history(hist, 8, 10)
    assert capsys.readouterr().out == want


def test_init_vectors_and_check_residual_match_jax(data_dir):
    counts = np.array([8, 12, 27, 18])
    for a, c in zip(cg.init_vectors(row_lengths=counts),
                    jax_cg.init_vectors(row_lengths=counts)):
        np.testing.assert_array_equal(a, c)
    csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
    x, b, xe = cg.init_vectors(csr, generated=False)
    assert xe is None and (b == 1).all() and (x == 0).all()
    x = np.linspace(0, 1, 7)
    assert cg.check_residual(x, np.ones(7)) == jax_cg.check_residual(
        x, np.ones(7))


def test_solver_scalars():
    num = torch.tensor([1.0, 2.0])
    den = torch.tensor([0.0, 4.0])
    assert torch.equal(cg.safe_div(num, den), torch.tensor([0.0, 0.5]))
    assert cg.default_acc_dtype(torch.bfloat16, None) == torch.float32
    assert cg.default_acc_dtype(torch.float32, None) == torch.float32
    assert cg.default_acc_dtype(torch.float32, torch.float64) == torch.float64
    u = torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16)
    d = ddot(u, u, acc_dtype=torch.float32)
    assert d.dtype == torch.float32 and float(d) == 14.0
    assert torch.equal(waxpby(2.0, u.float(), -1.0, u.float()),
                       u.float())


@pytest.mark.parametrize("kwargs,where", [
    ({"variant": "sstep", "precond": "p"}, "'standard', 'cs' and 'pipe'"),
    ({"variant": "fused", "inv_diag": np.ones(64)}, "unpreconditioned"),
    ({"variant": "nope"}, "variant must be"),
])
def test_unported_cg_options_raise(kwargs, where):
    """Every CG variant and preconditioner is ported; the combinations the
    JAX package refuses raise ValueError with its wording."""
    from sparsebench_tpu_torch.solvers.precond import ChebPrecond

    if kwargs.get("precond") == "p":
        kwargs = {**kwargs, "precond": ChebPrecond(1.0, 30.0, 2)}
    A, counts = DiaMatrix.from_stencil(4, 4, 4, device=CPU)
    with pytest.raises(ValueError, match=where):
        cg.solve_cg(A, np.ones(64), itermax=5, verbose=False, **kwargs)
