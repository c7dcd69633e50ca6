"""The body of standard CG: ``cg_run``'s plain stages
(``sparsebench_tpu_torch/ops/cg_body.py``) and its fused run, K15 at k = 1
(``ops/cg_multi_body.py``, ``csrc/cg_multi_body.cu``), without the JAX
package.

Here on the CPU: the rule that picks the body, the plain stages against
the eager body they were cut from (``eager_run``, the body ``cg_run`` ran
inline before), bit for bit, and a CPU state refused by the kernels' run.
The tests marked ``cuda`` (on a card: ``python -m pytest
tests/test_torch_cg_body.py --noconftest -q``) hold the fused run to the
plain stages on the card: k and the history to the ROADMAP
parity floors (f64: rtol 1e-9 where normr >= 1e-10 normr0; f32: rtol 1e-4
where normr >= 1e-4 normr0), the early exit, the breakdown freeze and a zero
right-hand side exactly, segments and repeated solves bit for bit, the
inputs untouched, what a body launches, the same on each other format
whose SpMV reaches ``cg_run`` (stencil, bslab, bsell, CSR, SELL), and an
SpMV product of another dtype than the vectors' sending the run to the
plain body.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats import from_csr
from sparsebench_tpu_torch.formats.bsell import BsellMatrix
from sparsebench_tpu_torch.formats.bslab import BslabMatrix
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.formats.stencil import StencilOperator
from sparsebench_tpu_torch.host import HostCSR, generate_stencil
from sparsebench_tpu_torch.ops import _build, cg_body, cg_multi_body
from sparsebench_tpu_torch.ops.blas1 import ddot, safe_div
from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv
from sparsebench_tpu_torch.solvers import cg, checkpoint

CPU = torch.device("cpu")
FROM_STENCIL = {"dia": DiaMatrix, "stencil": StencilOperator,
                "bslab": BslabMatrix, "bsell": BsellMatrix}
DT = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
FLOOR = {"f64": (1e-10, 1e-9), "f32": (1e-4, 1e-4)}


def eager_run(A, state, k_end, eps, apply_m=None):
    """The eager body as ``cg_run`` ran it inline, operation for
    operation: the reference for the plain stages."""
    k, x, p, r, rtrans, normr, hist, done = state
    vdt = r.dtype
    sdt = cg.default_acc_dtype(vdt, None)
    eps = torch.as_tensor(eps, dtype=sdt, device=r.device)
    steps = torch.arange(hist.numel(), device=r.device)
    spmv = cg.matvec(A)
    for _ in range(k_end - 1):
        active = (k < k_end) & (normr > eps) & ~done
        first = k == 1
        if apply_m is None:
            new_rtrans = ddot(r, r, acc_dtype=sdt)
            rt = torch.where(first, rtrans, new_rtrans)
            beta = torch.where(first, 0, safe_div(new_rtrans, rtrans)).to(vdt)
            p_new = r + beta * p
            normr_new = torch.sqrt(rt)
        else:
            z = apply_m(r)
            rz = ddot(r, z, acc_dtype=sdt)
            rt = torch.where(first, rtrans, rz)
            beta = torch.where(first, 0, safe_div(rz, rtrans)).to(vdt)
            p_new = z + beta * p
            normr_new = torch.sqrt(ddot(r, r, acc_dtype=sdt))
        hist = torch.where(active & (steps == k), normr_new, hist)
        Ap = spmv(p_new)
        pAp = ddot(p_new, Ap, acc_dtype=sdt)
        breakdown = pAp <= rt * 1e-30
        alpha = torch.where(breakdown | ~active, 0, safe_div(rt, pAp)).to(vdt)
        x = x + alpha * p_new
        r = r - alpha * Ap
        p = torch.where(active, p_new, p)
        rtrans = torch.where(active, rt, rtrans)
        normr = torch.where(active, normr_new, normr)
        done = done | (active & breakdown)
        k = k + active.to(k.dtype)
    return k, x, p, r, rtrans, normr, hist, done


def plain_run(A, state, k_end, eps):
    """The plain stages, unpreconditioned, on any device: ``cg_run``'s body
    where the kernels do not engage."""
    r = state[3]
    sdt = cg.default_acc_dtype(r.dtype, None)
    eps = torch.as_tensor(eps, dtype=sdt, device=r.device)
    return cg_body.plain_bodies(cg.matvec(A), state, k_end - 1, k_end, eps,
                                sdt)


def problem(dims, dt, device, seed=0):
    """The stencil of ``dims`` in DIA for ``dt`` vectors, and b = A x* for
    x* uniform in [0, 1): f32 stays above its rounding floor (the
    generated b, whose solution is all ones, reaches exact zeros)."""
    A, _ = DiaMatrix.from_stencil(*dims, device=device,
                                  policy=DTypePolicy.from_names(dt))
    g = torch.Generator().manual_seed(seed)
    xs = torch.rand(A.nr, generator=g, dtype=torch.float64)
    return A, A.spmv(xs.to(device=device, dtype=DT[dt]))


def format_problem(fmt, dims, dt, device, seed=0):
    """The stencil of ``dims`` in format ``fmt`` as the CLI builds it (the
    device builds where a format has one, else through the host CSR), and
    b = A x* for x* uniform in [0, 1)."""
    policy = DTypePolicy.from_names(dt)
    if fmt in FROM_STENCIL:
        A, _ = FROM_STENCIL[fmt].from_stencil(*dims, device=device,
                                              policy=policy)
    else:
        A = from_csr(fmt, generate_stencil(*dims), policy, device=device)
    g = torch.Generator().manual_seed(seed)
    xs = torch.rand(A.nr, generator=g, dtype=torch.float64)
    return A, A.spmv(xs.to(device=device, dtype=DT[dt]))


def two_i(dt, device, n=300):
    """2 I in DIA (``test_cg_breakdown_matches_jax``'s operator)."""
    csr = HostCSR(row_ptr=np.arange(n + 1), col=np.arange(n),
                  val=np.full(n, 2.0), nr=n, nc=n)
    return DiaMatrix.from_csr(csr, DTypePolicy.from_names(dt), device=device)


def assert_same_state(a, b):
    """Every entry of two states equal bit for bit, NaN where NaN."""
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        if u.is_floating_point():
            nan = u.isnan()
            assert torch.equal(nan, v.isnan())
            u, v = u[~nan], v[~nan]
        assert torch.equal(u, v)


# -- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("device,vdt,sdt,pre,kind", [
    ("cuda", "f32", "f32", False, "kernel"),
    ("cuda", "f64", "f64", False, "kernel"),
    ("cuda", "bf16", "f32", False, "torch"),
    ("cuda", "f32", "f64", False, "torch"),
    ("cuda", "f64", "f32", False, "torch"),
    ("cuda", "f32", "f32", True, "torch"),
    ("cuda", "f64", "f64", True, "torch"),
    ("cpu", "f32", "f32", False, "torch"),
    ("cpu", "f64", "f64", False, "torch"),
    ("cpu", "bf16", "f32", True, "torch"),
])
def test_body_kind_follows_the_input(device, vdt, sdt, pre, kind):
    assert cg_multi_body.body_kind(device, DT[vdt], DT[sdt], pre) == kind


@pytest.mark.parametrize("dt,dims,kw", [
    ("f64", (8, 7, 6), {}),
    ("f32", (8, 7, 6), {}),
    ("bf16", (8, 7, 6), {}),
    ("f32", (11, 13, 7), {"eps": 1e-2}),
    ("f64", (8, 7, 6), {"jacobi": True}),
    ("f64", (1, 1, 1), {}),
])
def test_plain_stages_are_the_eager_body(dt, dims, kw):
    """On the CPU ``cg_run`` runs the plain stages; they give the eager
    body's state bit for bit, every entry and dtype."""
    A, b = problem(dims, dt, CPU)
    itermax = 30
    apply_m = None
    inv_diag = None
    if kw.get("jacobi"):
        inv_diag = torch.full_like(b, 1 / 26)
        apply_m = lambda r: (inv_diag * r).to(b.dtype)  # noqa: E731
    eps = kw.get("eps", 0.0)
    state = cg.cg_init(A, b, torch.zeros_like(b), itermax, inv_diag=inv_diag)
    want = eager_run(A, state, itermax, eps, apply_m)
    got = cg.cg_run(A, state, itermax, eps, inv_diag=inv_diag)
    assert_same_state(got, want)
    if kw.get("eps"):
        assert int(got[0]) < itermax


def test_plain_stages_freeze_on_breakdown():
    """2 I, b = 1 on the CPU: the plain stages end at k = 3 with done and
    x = 0.5, as the eager body does."""
    A = two_i("f64", CPU)
    b = torch.ones(A.nr, dtype=torch.float64)
    state = cg.cg_init(A, b, torch.zeros_like(b), 20)
    got = cg.cg_run(A, state, 20, 0.0)
    assert_same_state(got, eager_run(A, state, 20, 0.0))
    assert int(got[0]) == 3 and bool(got[7])
    assert torch.equal(got[1], torch.full_like(b, 0.5))


def test_cpu_runs_launch_no_fused_kernel():
    A, b = problem((8, 7, 6), "f32", CPU)
    before = profiler.kernels()["K15"].launches
    cg.cg_loop(A, b, torch.zeros_like(b), 10, 0.0)
    assert profiler.kernels()["K15"].launches == before


def test_run_refuses_what_the_kernels_do_not_take():
    A, b = problem((4, 3, 2), "f32", CPU)
    state = cg.cg_init(A, b, torch.zeros_like(b), 5)
    with pytest.raises(TypeError, match="no kernel"):
        cg.kernel_run(state, 5, torch.zeros(()))


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused body has no CPU mode)")
    return torch.device("cuda")


def solve_both(A, b, itermax, eps=0.0, x0=None):
    x0 = torch.zeros_like(b) if x0 is None else x0
    state = cg.cg_init(A, b, x0, itermax)
    return cg.cg_run(A, state, itermax, eps), plain_run(A, state, itermax, eps)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("dims,itermax", [
    ((1, 1, 1), 10), ((11, 13, 7), 60), ((100, 100, 100), 150),
    ((200, 200, 200), 150),
])
def test_fused_run_matches_the_plain_body(dims, itermax, dt, cuda_device):
    """n = 1, an odd n (1001, no multiple of a block or a 16-byte pack),
    100^3 and 200^3: the same k, done and NaN pattern, the history to the
    parity floor of the dtype."""
    A, b = problem(dims, dt, cuda_device)
    before = profiler.kernels()["K15"].launches
    fused, plain = solve_both(A, b, itermax)
    assert profiler.kernels()["K15"].launches - before == 3 * (itermax - 1) + 1
    assert int(fused[0]) == int(plain[0])
    assert bool(fused[7]) == bool(plain[7])
    if A.nr > 1:  # one row may solve exactly and break down
        assert int(fused[0]) == itermax
    hf, hp = fused[6].cpu().numpy(), plain[6].cpu().numpy()
    assert (np.isnan(hf) == np.isnan(hp)).all()
    floor, rtol = FLOOR[dt]
    sel = hp >= floor * hp[0]
    assert sel[:2].all()
    np.testing.assert_allclose(hf[sel], hp[sel], rtol=rtol)
    assert bool(torch.isfinite(fused[1]).all())
    if dt == "f64":
        torch.testing.assert_close(fused[1], plain[1], rtol=0, atol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("fmt", ["stencil", "bslab", "bsell", "crs",
                                 "sell"])
def test_fused_run_matches_the_plain_body_on_each_format(fmt, dt,
                                                         cuda_device):
    """Every format whose SpMV reaches ``cg_run`` on the card (DIA above),
    at an odd mid size (47 x 41 x 37, 71299 rows): the fused body engages
    and gives the plain body's k, done and NaN pattern and its history to
    the parity floor of the dtype."""
    A, b = format_problem(fmt, (47, 41, 37), dt, cuda_device)
    before = profiler.kernels()["K15"].launches
    fused, plain = solve_both(A, b, 100)
    assert profiler.kernels()["K15"].launches - before == 3 * 99 + 1
    assert int(fused[0]) == int(plain[0]) == 100
    assert not bool(fused[7]) and not bool(plain[7])
    hf, hp = fused[6].cpu().numpy(), plain[6].cpu().numpy()
    assert (np.isnan(hf) == np.isnan(hp)).all()
    floor, rtol = FLOOR[dt]
    sel = hp >= floor * hp[0]
    assert sel[:2].all()
    np.testing.assert_allclose(hf[sel], hp[sel], rtol=rtol)


@pytest.mark.cuda
def test_a_product_of_another_dtype_takes_the_plain_body(cuda_device):
    """CSR keeps its values' dtype in its product: f32 values under f64
    vectors give an f32 Ap, which the kernels do not read. The run then
    takes the plain body from the state it started from, with torch's type
    promotion, bit for bit; only the probe's r.r and A launched."""
    A, _b = format_problem("crs", (9, 8, 7), "f32", cuda_device)
    b = torch.rand(A.nr, generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64).to(cuda_device)
    assert A.spmv(b).dtype == torch.float32
    wrappers = (cg_multi_body.body_rr, cg_multi_body.body_p,
                cg_multi_body.body_pap, cg_multi_body.body_xr)
    before = [w.launches for w in wrappers]
    fused, plain = solve_both(A, b, 30)
    assert [w.launches - n for w, n in zip(wrappers, before)] == [1, 1, 0, 0]
    assert_same_state(fused, plain)
    assert int(fused[0]) == 30


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fused_run_exits_early_as_the_plain_body(dt, cuda_device):
    A, b = problem((16, 16, 16), dt, cuda_device)
    fused, plain = solve_both(A, b, 150, eps=1e-3)
    assert int(fused[0]) == int(plain[0]) < 150
    hf, hp = fused[6].cpu().numpy(), plain[6].cpu().numpy()
    assert (np.isnan(hf) == np.isnan(hp)).all()
    np.testing.assert_allclose(hf[~np.isnan(hp)], hp[~np.isnan(hp)],
                               rtol=FLOOR[dt][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fused_run_freezes_on_breakdown(dt, cuda_device):
    """2 I, b = 1: k = 3, done, x = 0.5 and the history NaN beyond, as the
    plain body gives them (every sum here is exact)."""
    A = two_i(dt, cuda_device)
    b = torch.ones(A.nr, dtype=DT[dt], device=cuda_device)
    fused, plain = solve_both(A, b, 20)
    assert int(fused[0]) == int(plain[0]) == 3
    assert bool(fused[7]) and bool(plain[7])
    assert torch.equal(fused[1], torch.full_like(b, 0.5))
    assert torch.equal(fused[1], plain[1])
    assert torch.equal(fused[6].isnan(), plain[6].isnan())
    assert torch.equal(fused[6][:3], plain[6][:3])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fused_run_with_zero_rhs_runs_no_iteration(dt, cuda_device):
    A, _b = problem((9, 8, 7), dt, cuda_device)
    b = torch.zeros(A.nr, dtype=DT[dt], device=cuda_device)
    fused, plain = solve_both(A, b, 20)
    assert int(fused[0]) == int(plain[0]) == 1
    assert not bool(fused[7]) and not bool(plain[7])
    assert torch.equal(fused[1], plain[1]) and not fused[1].any()
    assert torch.equal(fused[6].isnan(), plain[6].isnan())
    assert float(fused[6][0]) == 0 and fused[6][1:].isnan().all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fused_segments_equal_one_run(dt, cuda_device, tmp_path):
    """Segments, with k given on the host or not, and the checkpointed
    solve give the bits of one fused run."""
    A, b = problem((20, 19, 17), dt, cuda_device)
    x0 = torch.zeros_like(b)
    one = cg.cg_run(A, cg.cg_init(A, b, x0, 60), 60, 0.0)
    half = cg.cg_run(A, cg.cg_init(A, b, x0, 60), 25, 0.0, k_start=1)
    assert int(half[0]) == 25
    assert_same_state(cg.cg_run(A, half, 60, 0.0, k_start=25), one)
    assert_same_state(cg.cg_run(A, half, 60, 0.0), one)
    res = checkpoint.solve_cg_checkpointed(
        A, b, checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=7,
        itermax=60, verbose=False)
    assert res.iterations == 60
    np.testing.assert_array_equal(res.x, one[1].cpu().numpy())
    np.testing.assert_array_equal(res.residual_history, one[6].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fused_solves_repeat_bit_for_bit_and_keep_their_inputs(dt,
                                                              cuda_device):
    A, b = problem((100, 100, 100), dt, cuda_device)
    x0 = torch.rand(A.nr, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).to(device=cuda_device, dtype=DT[dt])
    b_in, x0_in = b.clone(), x0.clone()
    x1, k1, h1 = cg.cg_loop(A, b, x0, 150, 0.0)
    x2, k2, h2 = cg.cg_loop(A, b, x0, 150, 0.0)
    assert torch.equal(b, b_in) and torch.equal(x0, x0_in)
    assert int(k1) == int(k2) == 150
    assert torch.equal(x1, x2) and torch.equal(h1, h2)
    assert x1.data_ptr() != x0.data_ptr()


def device_ops(fn):
    """{device name: count} of the device operations of ``fn()``. Every
    kernel library is built first: a session opened after nvcc ran in the
    process can miss device events."""
    _build.build()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = profiler.device_name(e.name())
            out[name] = out.get(name, 0) + 1
    return out


@pytest.mark.cuda
def test_a_fused_body_launches_k1_and_the_three_kernels(cuda_device):
    """Per body: one K1 and one launch each of A, B and C (and one C a run
    for the starting r.r); ten more bodies add no other device operation,
    so no torch operation runs inside a body."""
    A, b = problem((32, 32, 32), "f32", cuda_device)
    x0 = torch.zeros_like(b)
    wrappers = (dia_spmv, cg_multi_body.body_rr, cg_multi_body.body_p,
                cg_multi_body.body_pap, cg_multi_body.body_xr)
    counts = {}
    for itermax in (10, 20):
        before = [w.launches for w in wrappers]
        ops = device_ops(lambda: cg.cg_loop(A, b, x0, itermax, 0.0))
        ran = [w.launches - n for w, n in zip(wrappers, before)]
        bodies = itermax - 1
        assert ran == [bodies + 1, 1, bodies, bodies, bodies]
        assert ops["dia_spmv_kernel"] == bodies + 1
        assert ops["cg_multi_p_kernel"] == ops["cg_multi_pap_kernel"] == (
            bodies)
        assert ops["cg_multi_xr_kernel"] == bodies + 1
        counts[itermax] = sum(ops.values()) - 4 * bodies - 2
    assert counts[10] == counts[20]


@pytest.mark.cuda
def test_run_refuses_vectors_the_kernels_do_not_take(cuda_device):
    A, b = problem((4, 3, 2), "bf16", cuda_device)
    state = cg.cg_init(A, b, torch.zeros_like(b), 5)
    with pytest.raises(TypeError, match="no kernel"):
        cg.kernel_run(state, 5, torch.zeros((), device=cuda_device))
    A, b = problem((4, 3, 2), "f32", cuda_device)
    k, x, p, r, rtrans, normr, hist, done = cg.cg_init(
        A, b, torch.zeros_like(b), 5)
    with pytest.raises(ValueError, match="X must be"):
        cg.kernel_run((k, x[:-1], p, r, rtrans, normr, hist, done), 5,
                      torch.zeros((), device=cuda_device))
