"""The fused body of simultaneous CG (``sparsebench_tpu_torch/ops/
cg_multi_body.py``, K15 in ``csrc/cg_multi_body.cu``), without the JAX
package.

Here on the CPU: the rule that picks the body (the single-RHS loop's
rule, then whether the SpMV's product is a slab the kernels read), the
checks that refuse a slab or a state before any launch, a run taking any
CG state (P, counts, done), and the CPU keeping the eager loop. The tests
marked ``cuda`` (on a card: ``python -m pytest
tests/test_torch_cg_multi_body.py --noconftest -q``) hold column c of a
fused blocked solve to the single-RHS solve of column c (``cg_loop``, K15
at k = 1) bit for bit (x, history, count)
on DIA and CRS, f32 and f64, k in {1, 3, 8}; the fused loop to the eager
loop (``eager_multi``, the loop's plain body) with a per-column eps that
freezes columns at different iterations (counts and NaN slots equal,
history and X to reduction order); a column that breaks down freezing
alone; what a body launches; the inputs untouched and repeated solves bit
for bit.
"""

import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sparsebench_tpu_torch import profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.crs import CRSMatrix
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.host import HostCSR
from sparsebench_tpu_torch.ops import _build, cg_multi_body
from sparsebench_tpu_torch.ops.blas1 import safe_div
from sparsebench_tpu_torch.ops.dia_spmm import dia_spmm
from sparsebench_tpu_torch.solvers import cg
from sparsebench_tpu_torch.solvers.cg_multi import cg_multi_loop, make_spmm_kn

CPU = torch.device("cpu")
DT = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
FORMATS = {"dia": DiaMatrix, "crs": CRSMatrix}
WRAPPERS = (cg_multi_body.body_rr, cg_multi_body.body_p,
            cg_multi_body.body_pap, cg_multi_body.body_xr)


def eager_multi(A, B, X0, itermax, eps):
    """The eager loop of ``cg_multi_loop``, operation for operation: the
    body that runs wherever K15 does not."""
    k = B.shape[0]
    vdt = B.dtype
    sdt = cg.default_acc_dtype(vdt, None)
    spmm = make_spmm_kn(A)

    def dots(U, V):
        return torch.sum(U.to(sdt) * V.to(sdt), dim=1)

    eps = torch.as_tensor(eps, device=B.device).to(sdt)
    X = X0
    R = B - spmm(X0)
    rtrans = dots(R, R)
    normr = torch.sqrt(rtrans)
    hist = torch.full((itermax, k), float("nan"), dtype=sdt, device=B.device)
    hist[0] = normr
    active = normr > eps
    P = torch.zeros_like(B)
    iters = torch.ones(k, dtype=torch.int32, device=B.device)
    for it in range(1, itermax):
        if it == 1:
            new_rtrans = rtrans
            beta = torch.zeros_like(rtrans)
        else:
            new_rtrans = dots(R, R)
            beta = safe_div(new_rtrans, rtrans)
        P = torch.where(active[:, None], R + beta[:, None].to(vdt) * P, P)
        normr_k = torch.sqrt(new_rtrans)
        hist[it] = torch.where(active, normr_k, float("nan"))
        AP = spmm(P)
        pAp = dots(P, AP)
        breakdown = pAp <= new_rtrans * 1e-30
        step = active & ~breakdown
        alpha = torch.where(step, safe_div(new_rtrans, pAp), 0).to(vdt)
        X = X + alpha[:, None] * P
        R = R - alpha[:, None] * AP
        iters = iters + active.to(torch.int32)
        active = step & (normr_k > eps)
        rtrans = new_rtrans
    return X, iters, hist


def problem(fmt, dims, dt, k, device, seed=0):
    """The stencil of ``dims`` in ``fmt`` for ``dt`` vectors, built on the
    device, and B (k, n) = A X* for X* uniform in [0, 1)."""
    A, _ = FORMATS[fmt].from_stencil(*dims, device=device,
                                     policy=DTypePolicy.from_names(dt))
    g = torch.Generator().manual_seed(seed)
    xs = torch.rand((k, A.nr), generator=g, dtype=torch.float64)
    B = make_spmm_kn(A)(xs.to(device=device, dtype=DT[dt]))
    return A, B.contiguous()


def diagonal(values, dt, device):
    """diag(values) in DIA: one stored diagonal."""
    n = len(values)
    csr = HostCSR(row_ptr=np.arange(n + 1), col=np.arange(n),
                  val=np.asarray(values, dtype=np.float64), nr=n, nc=n)
    return DiaMatrix.from_csr(csr, DTypePolicy.from_names(dt), device=device)


def same_bits(u, v):
    """Equal bit for bit, NaN where NaN."""
    if u.dtype != v.dtype or u.shape != v.shape:
        return False
    if u.is_floating_point():
        nan = u.isnan()
        if not torch.equal(nan, v.isnan()):
            return False
        u, v = u[~nan], v[~nan]
    return torch.equal(u, v)


# -- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("device,vdt,sdt,kind", [
    ("cuda", "f32", "f32", "kernel"),
    ("cuda", "f64", "f64", "kernel"),
    ("cuda", "bf16", "f32", "torch"),
    ("cuda", "f32", "f64", "torch"),
    ("cuda", "f64", "f32", "torch"),
    ("cpu", "f32", "f32", "torch"),
    ("cpu", "f64", "f64", "torch"),
    ("cpu", "bf16", "f32", "torch"),
])
def test_the_loop_takes_the_single_rhs_rule(device, vdt, sdt, kind):
    """The blocked loop asks the single-RHS loop's rule, unpreconditioned:
    CUDA with f32 or f64 vectors accumulated in their own dtype engages the
    kernels."""
    assert cg_multi_body.body_kind(device, DT[vdt], DT[sdt], False) == kind


def aligned_slab(shape, dt, offset=0):
    """A (shape) slab of ``dt`` whose data start ``offset`` elements into a
    fresh (aligned) allocation."""
    k, n = shape
    base = torch.zeros(k * n + offset, dtype=dt)
    return base[offset:].view(k, n)


@pytest.mark.parametrize("case,ok", [
    ("good", True), ("other dtype", False), ("other shape", False),
    ("transposed", False), ("strided rows", False), ("misaligned", False),
    ("one column", True),
])
def test_takes_only_contiguous_aligned_slabs(case, ok):
    """The product the kernels read: a contiguous (k, n) slab of the
    vectors' dtype whose data start 16-byte aligned."""
    k, n = 3, 40
    f32 = torch.float32
    t = {
        "good": lambda: aligned_slab((k, n), f32),
        "other dtype": lambda: aligned_slab((k, n), torch.float64),
        "other shape": lambda: aligned_slab((k, n + 4), f32),
        "transposed": lambda: aligned_slab((n, k), f32).t(),
        "strided rows": lambda: aligned_slab((k, 2 * n), f32)[:, ::2],
        "misaligned": lambda: aligned_slab((k, n), f32, offset=1),
        "one column": lambda: aligned_slab((1, n), f32).view(1, n),
    }[case]()
    shape = (1, n) if case == "one column" else (k, n)
    assert cg_multi_body.takes(t, f32, shape) is ok
    if not ok:
        with pytest.raises(ValueError, match="slab"):
            cg_multi_body.check_slab("AP", t, f32, CPU, shape)


def run_inputs(k=3, n=40, dt=torch.float32, itermax=5):
    X = torch.zeros((k, n), dtype=dt)
    R = torch.ones((k, n), dtype=dt)
    rtrans = torch.full((k,), float(n), dtype=dt)
    hist = torch.full((itermax, k), float("nan"), dtype=dt)
    return dict(X=X, R=R, P=torch.zeros_like(R), rtrans=rtrans,
                normr=rtrans.sqrt(), hist=hist,
                eps=torch.zeros(k, dtype=torch.float64),
                count=torch.ones(k, dtype=torch.int32),
                done=torch.zeros(k, dtype=torch.bool), k_end=itermax)


@pytest.mark.parametrize("bad,match", [
    (("R", lambda v: v.t()), "R must be"),
    (("R", lambda v: v[:, :-1]), "R must be"),
    (("R", lambda v: v.to(torch.float64)), "X must be"),
    (("X", lambda v: v[:-1]), "X must be"),
    (("X", lambda v: v.to(torch.float64)), "X must be"),
    (("rtrans", lambda v: v[:-1]), "rtrans must be"),
    (("eps", lambda v: v.to(torch.float32)), "eps must be"),
    (("hist", lambda v: v[:, :-1]), "hist must be"),
    (("hist", lambda v: v.t().contiguous().t()), "hist must be"),
    (("R", lambda v: v.reshape(-1)), r"\(k, n\)"),
    (("P", lambda v: v[:-1]), "P must be"),
    (("P", lambda v: v.t().contiguous().t()), "P must be"),
    (("P", lambda v: v.to(torch.float64)), "P must be"),
    (("count", lambda v: v[:-1]), "count must be"),
    (("count", lambda v: v.to(torch.int64)), "count must be"),
    (("done", lambda v: v[:-1]), "done must be"),
    (("done", lambda v: v.to(torch.int32)), "done must be"),
])
def test_run_refuses_bad_slabs_before_any_launch(bad, match):
    """Shapes, dtypes and strides are checked before the device: on the
    CPU a bad input is a ValueError, a good one the TypeError of no kernel,
    and nothing launches."""
    before = [w.launches for w in WRAPPERS]
    kw = run_inputs()
    name, change = bad
    kw[name] = change(kw[name])
    with pytest.raises(ValueError, match=match):
        cg_multi_body.Run(**kw)
    with pytest.raises(TypeError, match="no kernel"):
        cg_multi_body.Run(**run_inputs())
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.parametrize("state", ["P", "count", "done", "all"])
def test_run_accepts_any_cg_state(state):
    """A run starts from any CG state, not only P = 0, count 1 and done 0
    (a later segment of ``cg_run``): a given P, per-column counts and done
    flags pass every check (on the CPU the run then refuses the device,
    the TypeError of no kernel), and nothing launches."""
    before = [w.launches for w in WRAPPERS]
    kw = run_inputs()
    if state in ("P", "all"):
        kw["P"] = torch.linspace(-1, 1, 120).reshape(3, 40)
    if state in ("count", "all"):
        kw["count"] = torch.tensor([1, 4, 5], dtype=torch.int32)
    if state in ("done", "all"):
        kw["done"] = torch.tensor([False, True, False])
    with pytest.raises(TypeError, match="no kernel for torch.float32 slabs "
                       r"of \(3, 40\) on cpu"):
        cg_multi_body.Run(**kw)
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.parametrize("wrapper", ["body_pap", "body_xr"])
@pytest.mark.parametrize("ap", [
    lambda: aligned_slab((3, 40), torch.float64),
    lambda: aligned_slab((40, 3), torch.float32).t(),
    lambda: aligned_slab((3, 40), torch.float32, offset=2),
    lambda: aligned_slab((3, 36), torch.float32),
])
def test_wrappers_refuse_a_product_before_launching(wrapper, ap):
    """B and C check the SpMV's product against the run's slab before the
    launch (a run stand-in on the CPU: the check needs no card)."""
    run = types.SimpleNamespace(dtype=torch.float32, device=CPU,
                                shape=(3, 40))
    fn = getattr(cg_multi_body, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="AP must be"):
        fn(run, ap())
    assert fn.launches == before


@pytest.mark.parametrize("dt", ["f32", "f64", "bf16"])
def test_cpu_runs_the_eager_loop(dt):
    """On the CPU the loop is the eager one, operation for operation, and
    launches no K15."""
    A, B = problem("dia", (6, 5, 4), dt, 3, CPU)
    before = profiler.kernels()["K15"].launches
    got = cg_multi_loop(A, B, torch.zeros_like(B), 12, 0.0)
    want = eager_multi(A, B, torch.zeros_like(B), 12, 0.0)
    assert profiler.kernels()["K15"].launches == before
    for u, v in zip(got, want):
        assert same_bits(u, v)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused body has no CPU mode)")
    return torch.device("cuda")


def single_solves(A, B, itermax, eps=0.0):
    """Each column through ``cg_loop`` (K15 at k = 1 on a card): [(x, k,
    hist)]."""
    out = []
    for c in range(B.shape[0]):
        b = B[c].clone()
        e = eps[c] if torch.is_tensor(eps) and eps.dim() else eps
        out.append(cg.cg_loop(A, b, torch.zeros_like(b), itermax, e))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("fmt", ["dia", "crs"])
def test_column_c_of_the_blocked_solve_is_the_single_rhs_solve_of_column_c(
        fmt, dt, k, cuda_device):
    """Column c of the fused blocked solve is ``cg_loop``'s solve of column
    c: x, the history and the count, bit for bit."""
    A, B = problem(fmt, (20, 19, 17), dt, k, cuda_device, seed=k)
    before = [w.launches for w in WRAPPERS]
    X, iters, hist = cg_multi_loop(A, B, torch.zeros_like(B), 60, 0.0)
    assert [w.launches - n for w, n in zip(WRAPPERS, before)] == [0] + [59] * 3
    for c, (x, kk, h) in enumerate(single_solves(A, B, 60)):
        assert int(iters[c]) == int(kk) == 60
        assert same_bits(X[c], x), f"column {c}: x differs"
        assert same_bits(hist[:, c], h), f"column {c}: history differs"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("fmt", ["dia", "crs"])
def test_odd_n_columns_are_the_single_rhs_solves(fmt, dt, cuda_device):
    """n = 1001, no multiple of a 16-byte pack: the columns after the first
    start unaligned and are read lane by lane, in the order of the
    single-RHS run (one aligned column, read 16 bytes at a time) still."""
    A, B = problem(fmt, (11, 13, 7), dt, 3, cuda_device, seed=5)
    X, iters, hist = cg_multi_loop(A, B, torch.zeros_like(B), 40, 0.0)
    for c, (x, kk, h) in enumerate(single_solves(A, B, 40)):
        assert int(iters[c]) == int(kk)
        assert same_bits(X[c], x) and same_bits(hist[:, c], h)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_per_column_eps_freezes_as_the_eager_loop(dt, cuda_device):
    """eps a column, so that the columns freeze at different iterations:
    the counts and NaN slots equal the eager loop's, the history and X
    agree to reduction order; each column is its single-RHS solve bit for
    bit.
    40 iterations: with eps 0 the recursive residual of an f32 solve at
    16^3 keeps falling until its dots underflow (about iteration 85), where
    a breakdown follows the order of the sums."""
    A, B = problem("dia", (16, 16, 16), dt, 4, cuda_device, seed=9)
    B = B * torch.tensor([1.0, 1e-3, 10.0, 1.0], dtype=B.dtype,
                         device=cuda_device)[:, None]
    r0 = torch.linalg.vector_norm(B.double(), dim=1)
    eps = (r0 * torch.tensor([1e-2, 1e-3, 1e-4, 0.0],
                             device=cuda_device, dtype=torch.float64)).to(
        B.dtype)
    X, iters, hist = cg_multi_loop(A, B, torch.zeros_like(B), 40, eps)
    Xe, iters_e, hist_e = eager_multi(A, B, torch.zeros_like(B), 40, eps)
    its = iters.tolist()
    assert its == iters_e.tolist()
    assert its[0] < its[1] < its[2] < its[3] == 40
    assert torch.equal(hist.isnan(), hist_e.isnan())
    rtol = 1e-4 if dt == "f32" else 1e-9
    for c in range(4):
        h, he = hist[:, c], hist_e[:, c]
        sel = ~he.isnan() & (he >= (1e-4 if dt == "f32" else 1e-10) * he[0])
        torch.testing.assert_close(h[sel], he[sel], rtol=rtol, atol=0)
        scale = float(Xe[c].abs().max())
        assert float((X[c] - Xe[c]).abs().max()) <= rtol * 10 * scale
    for c, (x, kk, h) in enumerate(single_solves(A, B, 40, eps)):
        assert int(iters[c]) == int(kk)
        assert same_bits(X[c], x) and same_bits(hist[:, c], h)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_a_column_that_breaks_down_freezes_alone(dt, cuda_device):
    """diag(1 .. 300): a column along the eigenvector of 64 solves exactly
    in one step (every sum exact) and breaks down at k = 3, the others run
    every iteration; each column is its single-RHS solve bit for bit, and
    the eager loop gives the same counts."""
    A = diagonal(np.arange(1, 301), dt, cuda_device)
    B = torch.ones((3, 300), dtype=DT[dt], device=cuda_device)
    B[1] = 0
    B[1, 63] = 5.0
    B[2] = torch.linspace(1, 2, 300, dtype=DT[dt], device=cuda_device)
    X, iters, hist = cg_multi_loop(A, B, torch.zeros_like(B), 20, 0.0)
    assert iters.tolist() == [20, 3, 20]
    assert float(X[1, 63]) == 5.0 / 64 and int((X[1] != 0).sum()) == 1
    assert hist[:3, 1].tolist() == [5.0, 5.0, 0.0]
    assert hist[3:, 1].isnan().all() and not hist[:, 0].isnan().any()
    assert eager_multi(A, B, torch.zeros_like(B), 20, 0.0)[1].tolist() == [
        20, 3, 20]
    for c, (x, kk, h) in enumerate(single_solves(A, B, 20)):
        assert int(iters[c]) == int(kk)
        assert same_bits(X[c], x) and same_bits(hist[:, c], h)


@pytest.mark.cuda
def test_zero_columns_run_no_iteration(cuda_device):
    """A zero right-hand side beside a live one: its count stays 1, its x
    0 and its history NaN from iteration 1; the other column runs on."""
    A, B = problem("dia", (9, 8, 7), "f32", 2, cuda_device)
    B[0] = 0
    X, iters, hist = cg_multi_loop(A, B, torch.zeros_like(B), 20, 0.0)
    assert iters.tolist() == [1, 20]
    assert not X[0].any() and float(hist[0, 0]) == 0
    assert hist[1:, 0].isnan().all()


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
def test_a_fused_body_launches_k8_and_the_three_kernels(cuda_device):
    """Per body one K8 and one launch each of A, B and C, whatever k; ten
    more bodies add no other device operation."""
    A, B = problem("dia", (32, 32, 32), "f32", 8, cuda_device)
    X0 = torch.zeros_like(B)
    counts = {}
    for itermax in (10, 20):
        before = [w.launches for w in (dia_spmm, *WRAPPERS)]
        ops = device_ops(lambda: cg_multi_loop(A, B, X0, itermax, 0.0))
        ran = [w.launches - n for w, n in zip((dia_spmm, *WRAPPERS), before)]
        bodies = itermax - 1
        assert ran == [bodies + 1, 0, bodies, bodies, bodies]
        assert ops["cg_multi_p_kernel"] == ops["cg_multi_pap_kernel"] == (
            ops["cg_multi_xr_kernel"]) == bodies
        counts[itermax] = sum(ops.values()) - 4 * bodies
    assert counts[10] == counts[20]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_fused_solves_repeat_and_keep_their_inputs(dt, cuda_device):
    A, B = problem("dia", (24, 24, 24), dt, 8, cuda_device)
    X0 = torch.rand(B.shape, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).to(device=cuda_device, dtype=B.dtype)
    B_in, X0_in = B.clone(), X0.clone()
    one = cg_multi_loop(A, B, X0, 80, 0.0)
    two = cg_multi_loop(A, B, X0, 80, 0.0)
    assert torch.equal(B, B_in) and torch.equal(X0, X0_in)
    for u, v in zip(one, two):
        assert same_bits(u, v)
    assert one[0].data_ptr() != X0.data_ptr()
