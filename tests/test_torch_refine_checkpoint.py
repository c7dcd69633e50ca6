"""Port parity: mixed-precision refinement (``solvers/refine.py``) and
checkpoint/resume (``solvers/checkpoint.py``, ``cg_run``'s segment start)
of sparsebench_tpu_torch against the JAX package's, on the CPU.

Refinement's outer residuals are true f64 (or f32) norms, but each sweep's
correction comes from a low-precision CG, so the sweeps agree to the low
precision's rule: f64 -> f32 to rtol 1e-4 where normr >= 1e-4 normr0 (the
f32 rule). For f32 -> bf16 the JAX oracle is its Pallas DIA in interpret
mode (which widens bf16 x to f32, as the port does); bf16 vector updates
round at other places in XLA's fused loops than in eager torch, so the
sweeps agree to 2^-7 (two bf16 roundings) where normr >= 1e-2 normr0, the
floor of a bf16 inner solve (about 4e-3). The sweep counts of both end on
the same stagnation test and must be equal.

Checkpointing: a segmented solve gives the bits of one run; a state the
JAX package saved resumes in the port to the JAX one-run history (f64,
ROADMAP's rule: k equal, rtol 1e-9 where normr >= 1e-10 normr0).
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats.dia import DiaMatrix as JaxDia  # noqa: E402
from sparsebench_tpu.solvers import cg as jax_cg  # noqa: E402
from sparsebench_tpu.solvers import checkpoint as jax_ckpt  # noqa: E402
from sparsebench_tpu.solvers import refine as jax_refine  # noqa: E402
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats.dia import DiaMatrix  # noqa: E402
from sparsebench_tpu_torch.solvers import cg, checkpoint, refine  # noqa: E402

CPU = torch.device("cpu")


def carry(Aj):
    return DiaMatrix.from_jax_arrays(
        np.asarray(Aj.data), Aj.offsets, Aj.nr, Aj.nc, Aj.nnz, Aj.nr_pad,
        Aj.start_row, Aj.total_nr, Aj.total_nnz, device=CPU, impl="torch",
    )


def jax_stencil(dtype, impl="xla", dims=(10, 9, 7)):
    Aj, counts = JaxDia.from_stencil(*dims, policy=JaxPolicy.from_names(dtype),
                                     impl=impl)
    host = np.float64 if dtype == "f64" else np.float32
    _x, b, xexact = jax_cg.init_vectors(dtype=host,
                                        row_lengths=np.asarray(counts))
    return Aj, b, xexact


# -- refinement --------------------------------------------------------------


@pytest.mark.parametrize("hi,lo,lo_impl,floor,rtol", [
    ("f64", "f32", "xla", 1e-4, 1e-4),
    ("f32", "bf16", "pallas_interpret", 1e-2, 2.0 ** -7),
])
def test_refine_matches_jax(hi, lo, lo_impl, floor, rtol):
    Aj_hi, b, xexact = jax_stencil(hi)
    Aj_lo, _b, _xe = jax_stencil(lo, lo_impl)
    kw = dict(outer_max=8, inner_iters=40, verbose=False)
    rj = jax_refine.solve_cg_refine(Aj_hi, b, A_lo=Aj_lo, **kw)
    rt = refine.solve_cg_refine(carry(Aj_hi), b, A_lo=carry(Aj_lo), **kw)
    hj, ht = np.asarray(rj.residual_history), rt.residual_history
    assert ht.size == hj.size >= 3  # the same number of sweeps
    sel = hj >= floor * hj[0]
    assert sel.sum() >= 2
    np.testing.assert_allclose(ht[sel], hj[sel], rtol=rtol)
    tol = 1e-9 if hi == "f64" else 1e-5
    assert cg.check_residual(rt.x, xexact) < tol
    assert cg.check_residual(np.asarray(rj.x), xexact) < tol


def test_refine_dtypes_and_refusals():
    assert refine.refine_lo_dtype(torch.float64) == torch.float32
    assert refine.refine_lo_dtype(torch.float32) == torch.bfloat16
    with pytest.raises(ValueError, match="headroom below bfloat16"):
        refine.refine_lo_dtype(torch.bfloat16)
    lo, name = refine.refine_lo_policy(DTypePolicy.from_names("f64", "i64"))
    assert name == "f32" and lo == DTypePolicy.from_names("f32", "i64")
    A = DiaMatrix.from_stencil(4, 4, 4, device=CPU)[0]
    with pytest.raises(ValueError, match="f32/f64"):
        refine.solve_cg_refine(A, torch.ones(64, dtype=torch.bfloat16))


def test_refine_eps_and_stagnation_exit_like_jax():
    """eps ends the sweeps where the JAX loop ends them; eps 0 stops on
    stagnation (the f32 floor) before outer_max."""
    Aj, b, _xe = jax_stencil("f64")
    Aj_lo, _b, _ = jax_stencil("f32")
    for eps, outer in ((1e-6, 12), (0.0, 30)):
        kw = dict(outer_max=outer, inner_iters=30, eps=eps, verbose=False)
        rj = jax_refine.solve_cg_refine(Aj, b, A_lo=Aj_lo, **kw)
        rt = refine.solve_cg_refine(carry(Aj), b, A_lo=carry(Aj_lo), **kw)
        assert rt.residual_history.size == rj.residual_history.size
        sweeps = rt.residual_history.size - 1
        assert sweeps < outer
        # an f32 inner solve's eps exit can land one step apart in f32
        # noise (ROADMAP compares f32 k nowhere)
        assert abs(rt.iterations - rj.iterations) <= sweeps


# -- checkpoint / resume -----------------------------------------------------


def problem(dims=(8, 7, 6)):
    A, counts = DiaMatrix.from_stencil(*dims, device=CPU,
                                       policy=DTypePolicy.from_names("f64"))
    _x, b, xexact = cg.init_vectors(row_lengths=counts)
    return A, torch.from_numpy(b), xexact


def test_cg_run_segment_start_runs_k_end_minus_k_bodies(monkeypatch):
    """With the state's k given on the host, a segment issues exactly
    k_end - k bodies (one SpMV each), and two segments give the bits of one
    run."""
    A, b, _xe = problem()
    x0 = torch.zeros_like(b)
    one = cg.cg_run(A, cg.cg_init(A, b, x0, 60), 60, 0.0)
    calls = []
    spmv = A.spmv
    monkeypatch.setattr(A, "spmv", lambda x: calls.append(1) or spmv(x))
    half = cg.cg_run(A, cg.cg_init(A, b, x0, 60), 25, 0.0, k_start=1)
    assert int(half[0]) == 25 and len(calls) == 1 + 24
    calls.clear()
    two = cg.cg_run(A, half, 60, 0.0, k_start=25)
    assert len(calls) == 60 - 25
    for a, c in zip(one, two):
        assert torch.equal(a, c)


@pytest.mark.parametrize("every", [7, 50, 200])
def test_segmented_solve_equals_one_run(every, tmp_path):
    A, b, xexact = problem()
    path = str(tmp_path / "ck.npz")
    res = checkpoint.solve_cg_checkpointed(A, b, checkpoint_path=path,
                                           checkpoint_every=every,
                                           itermax=80, verbose=False)
    x, k, hist = cg.cg_loop(A, b, torch.zeros_like(b), 80, 0.0)
    assert res.iterations == int(k) == 80
    np.testing.assert_array_equal(res.x, x.numpy())
    np.testing.assert_array_equal(res.residual_history, hist.numpy())
    assert cg.check_residual(res.x, xexact) < 1e-10


def test_resume_after_interrupt_and_grow(tmp_path, capsys):
    """A run to 30 then a resumed run to 70 gives the one-run bits of 70,
    the history grown from 30 slots."""
    A, b, _xe = problem()
    path = str(tmp_path / "ck.npz")
    checkpoint.solve_cg_checkpointed(A, b, checkpoint_path=path,
                                     checkpoint_every=10, itermax=30,
                                     verbose=False)
    res = checkpoint.solve_cg_checkpointed(A, b, checkpoint_path=path,
                                           checkpoint_every=10, itermax=70)
    out = capsys.readouterr().out
    assert f"Resuming from {path} at iteration 30" in out
    assert "checkpoint @ iteration 70" in out
    x, k, hist = cg.cg_loop(A, b, torch.zeros_like(b), 70, 0.0)
    np.testing.assert_array_equal(res.x, x.numpy())
    np.testing.assert_array_equal(res.residual_history, hist.numpy())


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package writes the state at k = 30; the port resumes it to
    60 and matches the JAX one-run history and x; the port's state resumes
    in the JAX package too."""
    Aj, b, xexact = jax_stencil("f64", dims=(8, 7, 6))
    path = str(tmp_path / "ck.npz")
    jax_ckpt.solve_cg_checkpointed(Aj, b, checkpoint_path=path,
                                   checkpoint_every=30, itermax=30,
                                   verbose=False)
    with np.load(path) as z:
        assert set(checkpoint._STATE_KEYS) <= set(z.files)
    rt = checkpoint.solve_cg_checkpointed(carry(Aj), b, checkpoint_path=path,
                                          checkpoint_every=30, itermax=60,
                                          verbose=False)
    rj = jax_cg.solve_cg(Aj, b, itermax=60, verbose=False)
    assert rt.iterations == rj.iterations == 60
    hj = np.asarray(rj.residual_history)
    sel = hj >= 1e-10 * hj[0]
    np.testing.assert_allclose(rt.residual_history[sel], hj[sel], rtol=1e-9)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-10)
    # and back: the port's file at k = 60 resumes in the JAX package
    rj2 = jax_ckpt.solve_cg_checkpointed(Aj, b, checkpoint_path=path,
                                         checkpoint_every=30, itermax=90,
                                         verbose=False)
    rj90 = jax_cg.solve_cg(Aj, b, itermax=90, verbose=False)
    assert rj2.iterations == 90
    h90 = np.asarray(rj90.residual_history)
    sel = h90 >= 1e-10 * h90[0]
    np.testing.assert_allclose(rj2.residual_history[sel], h90[sel],
                               rtol=1e-9)


def test_state_roundtrip_keeps_dtypes(tmp_path):
    """save_state/load_state: the JAX package's keys; bf16 vectors widen to
    f32 in the file and narrow back exactly."""
    A, counts = DiaMatrix.from_stencil(4, 4, 4, device=CPU,
                                       policy=DTypePolicy.from_names("bf16"))
    b = torch.from_numpy(27.0 - (counts - 1.0)).to(torch.bfloat16)
    state = cg.cg_run(A, cg.cg_init(A, b, torch.zeros_like(b), 10), 5, 0.0)
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, state)
    back = checkpoint.load_state(path, torch.bfloat16, torch.float32, CPU)
    for a, c in zip(state, back):
        assert a.dtype == c.dtype
        assert torch.equal(torch.nan_to_num(a.float()),
                           torch.nan_to_num(c.float()))
    with np.load(path) as z:
        assert set(z.files) == set(checkpoint._STATE_KEYS)
        assert z["x"].dtype == np.float32


def test_save_state_creates_its_directory(tmp_path):
    """A checkpoint path under a directory that does not exist yet (such as
    ``build/`` in a fresh checkout) is written, and resumes."""
    A, counts = DiaMatrix.from_stencil(4, 4, 4, device=CPU,
                                       policy=DTypePolicy.from_names("f64"))
    b = torch.from_numpy(27.0 - (counts - 1.0))
    state = cg.cg_run(A, cg.cg_init(A, b, torch.zeros_like(b), 10), 5, 0.0)
    path = str(tmp_path / "build" / "ck.npz")
    checkpoint.save_state(path, state)
    back = checkpoint.load_state(path, torch.float64, torch.float64, CPU)
    assert all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))
               for a, c in zip(state, back))
