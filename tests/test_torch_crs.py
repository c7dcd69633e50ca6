"""The CRS format of the port (``sparsebench_tpu_torch/formats/crs.py``):
its on-device build of the generated stencil, its SpMV (the plain version
on the CPU; K14, ``ops/crs_spmv.py`` and ``csrc/crs_spmv.cu``, on a card),
its spans, and the CLI's route to it, without the JAX package.

Here on the CPU: ``from_stencil`` equal element for element to
``from_csr(generate_stencil(...))``; the SpMV and a CG solve against the
benchmark's plain f64 reference (``bench_torch/reference/hpcg.py``); the
spans; K14 in the registry; the CPU path bit for bit as it was. The tests
marked ``cuda`` (on a card: ``python -m pytest tests/test_torch_crs.py
--noconftest -q``) hold K14 to the plain version. K14 sums a row in stored
order from 0 and the plain version in torch's order; each is within
len_i u (|A| |x|)_i of the exact sum (u the unit roundoff, len_i the
row's entries; products and sums rounded to nearest), so the two are held
to 2 len_i u (|A| |x|)_i. A 200^3 CG through K14 and the fused body K15 is
held to the reference's history to the ROADMAP parity floor (f32: rtol
1e-4 where the reference's residual is at least 1e-4 of its start).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sparsebench_tpu_torch import cli, profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats import crs as crs_mod
from sparsebench_tpu_torch.formats import from_csr, get_format
from sparsebench_tpu_torch.formats.crs import CCRSMatrix, CRSMatrix
from sparsebench_tpu_torch.host import HostCSR, generate_stencil, read_mm
from sparsebench_tpu_torch.ops import cg_multi_body
from sparsebench_tpu_torch.ops import crs_spmv as crs_ops
from sparsebench_tpu_torch.ops.crs_spmv import (
    crs_spmv,
    crs_spmv_torch,
    kernel_applies,
)
from sparsebench_tpu_torch.solvers import cg

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).resolve().parent / "data"
UNIT = {torch.float32: 2.0 ** -24, torch.float64: 2.0 ** -53}


def _reference():
    path = ROOT / "bench_torch" / "reference" / "hpcg.py"
    spec = importlib.util.spec_from_file_location("bench_reference_hpcg",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


hpcg = _reference()


def grid_cfg(dims, points=27, itermax=40):
    nx, ny, nz = dims
    return {"nx": nx, "ny": ny, "nz": nz, "stencil_points": points,
            "diagonal": 27.0, "off_diagonal": -1.0, "itermax": itermax,
            "eps": 0.0}


@pytest.fixture
def recorder():
    profiler.RECORDER.clear()
    yield profiler
    profiler.set_mode("auto")
    profiler.RECORDER.clear()


# -- the on-device build ------------------------------------------------------

GRIDS = [(10, 9, 7), (13, 5, 4), (7, 3, 11), (1, 1, 1), (2, 2, 2), (1, 5, 6),
         (130, 2, 3), (3, 1, 4)]


@pytest.mark.parametrize("use_7pt", [False, True])
@pytest.mark.parametrize("dims", GRIDS)
def test_from_stencil_equals_the_host_build(dims, use_7pt, monkeypatch):
    """Odd and unequal grids, thin ones whose neighbour shifts alias, in
    row chunks of 7 so that chunks split rows of every kind."""
    monkeypatch.setattr(crs_mod, "BUILD_ROWS", 7)
    policy = DTypePolicy.from_names("f32")
    A, counts = CRSMatrix.from_stencil(*dims, device=CPU, use_7pt=use_7pt,
                                       policy=policy)
    h = generate_stencil(*dims, use_7pt=use_7pt)
    B = CRSMatrix.from_csr(h, policy, device=CPU)
    for f in ("row_ptr", "col", "val"):
        a, b = getattr(A, f), getattr(B, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    for f in ("nr", "nc", "nnz", "start_row", "total_nr", "total_nnz",
              "impl"):
        assert getattr(A, f) == getattr(B, f), f
    np.testing.assert_array_equal(counts, h.row_lengths)
    # each row's columns ascend, as the reference's generator writes them
    rows = np.repeat(np.arange(h.nr), h.row_lengths)
    step = np.diff(A.col.numpy().astype(np.int64))
    assert (step[rows[1:] == rows[:-1]] > 0).all()


@pytest.mark.parametrize("rank,size", [(0, 3), (1, 3), (2, 3)])
def test_from_stencil_equals_the_host_build_on_each_rank(rank, size):
    A, counts = CRSMatrix.from_stencil(6, 5, 4, device=CPU, rank=rank,
                                       size=size)
    h = generate_stencil(6, 5, 4, rank=rank, size=size)
    B = CRSMatrix.from_csr(h, device=CPU)
    for f in ("row_ptr", "col", "val"):
        assert torch.equal(getattr(A, f), getattr(B, f)), f
    assert (A.start_row, A.total_nr, A.total_nnz) == (
        B.start_row, B.total_nr, B.total_nnz)
    np.testing.assert_array_equal(counts, h.row_lengths)


@pytest.mark.parametrize("value,index", [("f32", "i32"), ("f64", "i64"),
                                         ("bf16", "i32")])
def test_from_stencil_stores_the_policy_dtypes(value, index):
    policy = DTypePolicy.from_names(value, index)
    A, _ = CRSMatrix.from_stencil(5, 4, 3, device=CPU, policy=policy)
    assert A.val.dtype == policy.value
    assert A.col.dtype == A.row_ptr.dtype == policy.index
    assert set(A.val.float().unique().tolist()) == {-1.0, 27.0}


def test_ccrs_inherits_the_build():
    A, _ = get_format("ccrs").from_stencil(4, 4, 4, device=CPU)
    assert type(A) is CCRSMatrix and A.name == "ccrs"
    B, _ = CRSMatrix.from_stencil(4, 4, 4, device=CPU)
    assert torch.equal(A.col, B.col) and torch.equal(A.val, B.val)


@pytest.mark.parametrize("past", ["entries", "columns"])
def test_from_stencil_refuses_indices_that_do_not_fit(past, monkeypatch):
    """More entries than int32 row pointers address widen the row
    pointers to int64 and keep int32 columns, the narrow build's matrix;
    more columns than the index dtype holds still raise."""
    narrow, _ = CRSMatrix.from_stencil(3, 3, 3, device=CPU)
    if past == "columns":
        monkeypatch.setattr(torch, "iinfo",
                            lambda dt: type("I", (), {"max": 10}))
        with pytest.raises(ValueError, match="27 columns do not fit"):
            CRSMatrix.from_stencil(3, 3, 3, device=CPU)
        return
    monkeypatch.setattr(crs_mod, "NARROW_ENTRIES", narrow.nnz - 1)
    wide, counts = CRSMatrix.from_stencil(3, 3, 3, device=CPU)
    assert narrow.row_ptr.dtype == torch.int32
    assert wide.row_ptr.dtype == torch.int64
    assert wide.col.dtype == torch.int32 and wide.nnz == narrow.nnz == 343
    assert torch.equal(wide.row_ptr, narrow.row_ptr.long())
    assert torch.equal(wide.col, narrow.col)
    assert torch.equal(wide.val, narrow.val)
    np.testing.assert_array_equal(counts, generate_stencil(3, 3, 3)
                                  .row_lengths)
    x = torch.rand(wide.nc, dtype=torch.float64)
    assert torch.equal(wide.spmv(x), narrow.spmv(x))



@pytest.mark.parametrize("above", [0, 1])
def test_the_threshold_picks_the_row_pointers(above, monkeypatch):
    """A matrix of exactly ``NARROW_ENTRIES`` entries keeps int32 row
    pointers; one entry more widens them."""
    narrow, _ = CRSMatrix.from_stencil(4, 3, 3, device=CPU)
    monkeypatch.setattr(crs_mod, "NARROW_ENTRIES", narrow.nnz - above)
    A, _ = CRSMatrix.from_stencil(4, 3, 3, device=CPU)
    assert A.row_ptr.dtype == (torch.int64 if above else torch.int32)
    assert A.col.dtype == torch.int32
    assert torch.equal(A.row_ptr.long(), narrow.row_ptr.long())


def test_the_threshold_keeps_the_narrow_chunk_start_an_int():
    """K14's narrow form steps an int chunk start by kChunk past the last
    entry, so it takes at most 2^31 - 1 - kChunk entries: the build's
    threshold is that limit, and ``kernel_applies`` sends int32 row
    pointers over more entries to the plain version."""
    src = (ROOT / "sparsebench_tpu_torch" / "csrc" / "crs_spmv.cu").read_text()
    chunk = int(re.search(r"constexpr int kChunk = (\d+);", src).group(1))
    assert crs_mod.NARROW_ENTRIES == crs_ops.NARROW_ENTRIES == 2**31 - 1 - chunk

    class Operand:
        def __init__(self, dtype, n=1):
            self.device, self.dtype, self.n = torch.device("cuda", 0), dtype, n

        def numel(self):
            return self.n

    x, col = Operand(torch.float32), Operand(torch.int32)
    for ptr, entries, applies in ((torch.int32, crs_ops.NARROW_ENTRIES, True),
                                  (torch.int32, crs_ops.NARROW_ENTRIES + 1,
                                   False),
                                  (torch.int64, crs_ops.NARROW_ENTRIES + 1,
                                   True)):
        val = Operand(torch.float32, entries)
        assert kernel_applies(val, col, Operand(ptr), x) is applies

# -- the SpMV and CG on the CPU ---------------------------------------------


@pytest.mark.parametrize("dims,points", [((12, 11, 9), 27), ((9, 10, 7), 7)])
def test_spmv_matches_the_reference(dims, points):
    A, _ = CRSMatrix.from_stencil(*dims, device=CPU,
                                  use_7pt=points == 7,
                                  policy=DTypePolicy.from_names("f64"))
    x = torch.rand(A.nr, generator=torch.Generator().manual_seed(11),
                   dtype=torch.float64)
    y_ref = hpcg.apply(x, grid_cfg(dims, points))
    torch.testing.assert_close(A.spmv(x), y_ref, rtol=0, atol=1e-12)
    # f32: x rounded once (u |A| |x|) and a sum of at most 27 terms (27 u
    # |A| |x|), |A| |x| <= 54 for x in [0, 1)
    A32, _ = CRSMatrix.from_stencil(*dims, device=CPU, use_7pt=points == 7,
                                    policy=DTypePolicy.from_names("f32"))
    y32 = A32.spmv(x.float())
    assert y32.dtype == torch.float32
    torch.testing.assert_close(y32.double(), y_ref, rtol=0,
                               atol=28 * UNIT[torch.float32] * 54)


def test_cg_matches_the_reference():
    """A 40-iteration f64 CG on seeded b = A x* against the reference's:
    the same iterations, the history to the f64 parity floor, x close."""
    dims = (11, 9, 8)
    cfg = grid_cfg(dims, itermax=40)
    A, _ = CRSMatrix.from_stencil(*dims, device=CPU,
                                  policy=DTypePolicy.from_names("f64"))
    xs = torch.rand(A.nr, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    b = hpcg.apply(xs, cfg)
    x, k, hist = cg.cg_loop(A, b, torch.zeros_like(b), 40, 0.0)
    x_ref, k_ref, h_ref = hpcg.cg(b[None], cfg)
    assert int(k) == int(k_ref[0]) == 40
    h, h_ref = hist.numpy(), h_ref[:, 0].numpy()
    sel = h_ref >= 1e-10 * h_ref[0]
    assert sel.sum() >= 20
    np.testing.assert_allclose(h[sel], h_ref[sel], rtol=1e-9)
    torch.testing.assert_close(x, x_ref[0], rtol=0, atol=1e-9)


def test_cpu_keeps_the_plain_path():
    """On the CPU the SpMV is the plain version, bit for bit, and launches
    nothing; asking for the kernel on the CPU raises."""
    A, _ = CRSMatrix.from_stencil(9, 8, 7, device=CPU)
    assert A.impl == "torch"
    x = torch.rand(A.nc, dtype=torch.float64)
    before = crs_spmv.launches
    y = A.spmv(x)
    assert torch.equal(y, crs_spmv_torch(A.val, A.col, A.row_ptr, x))
    assert torch.equal(crs_spmv(A.val, A.col, A.row_ptr, x), y)
    prod = A.val * torch.index_select(x, 0, A.col).to(A.val.dtype)
    assert torch.equal(y, torch.segment_reduce(prod, "sum",
                                               offsets=A.row_ptr))
    assert crs_spmv.launches == before
    assert not kernel_applies(A.val, A.col, A.row_ptr, x)
    with pytest.raises(ValueError, match="CUDA kernel"):
        CRSMatrix.from_stencil(3, 3, 3, device=CPU, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        CRSMatrix.from_csr(generate_stencil(3, 3, 3), device=CPU,
                           impl="kernel_win")


# -- spans and the registry ----------------------------------------------------


def test_build_and_spmv_spans(recorder):
    recorder.set_mode("on")
    A, _ = CRSMatrix.from_stencil(6, 5, 4, device=CPU, use_7pt=True)
    A.spmv(torch.ones(A.nc, dtype=torch.float64))
    recorder.set_mode("auto")
    spans = recorder.spans()
    names = [s.name for s in spans]
    assert names == ["crs.build", "crs.build.row_ptr", "crs.build.cols",
                     "crs.spmv"]
    build, ptr, cols, spmv = spans
    assert build.attrs == {"n": 120, "points": 7, "row_ptr": "i32",
                           "nnz": A.nnz}
    assert ptr.parent == cols.parent == 0 and build.parent is None
    assert build.start_ns <= ptr.start_ns <= ptr.end_ns <= cols.start_ns
    assert cols.end_ns <= build.end_ns
    assert spmv.attrs == {"kernel": "torch", "nnz": A.nnz, "row_ptr": "i32"}
    assert spmv.parent is None and spmv.request != build.request
    # the recorder off: no span
    A.spmv(torch.ones(A.nc, dtype=torch.float64))
    assert len(recorder.spans()) == 4


def test_k14_in_the_registry():
    k14 = profiler.kernels()["K14"]
    assert k14.names == ("crs_spmv_kernel", "crs_spmv_wide_kernel")
    assert k14.layer == "SpMV kernels"
    assert k14.wrappers == (crs_spmv,)
    event = ("void (anonymous namespace)::crs_spmv_kernel<float>(float "
             "const*, int const*, int const*, float const*, float*, int)")
    assert [k.id for k in profiler.kernels_named(event)] == ["K14"]
    wide = ("void (anonymous namespace)::crs_spmv_wide_kernel<double>("
            "double const*, int const*, long long const*, double const*, "
            "double*, int)")
    assert [k.id for k in profiler.kernels_named(wide)] == ["K14"]


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["crs", "ccrs"])
def test_cli_builds_generated_crs_on_the_device(fmt, monkeypatch, capsys):
    """``--fmt crs|ccrs`` on a generated problem takes ``from_stencil``:
    the host CSR is never built, and the solve is the host build's."""

    def no_host(_param):
        raise AssertionError("the host CSR was built")

    argv = ["-t", "cg", "-x", "9", "-y", "8", "-z", "7", "-i", "30",
            "--dtype", "f64", "--device", "cpu", "--fmt", fmt]
    with monkeypatch.context() as m:
        m.setattr(cli, "init_matrix", no_host)
        assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert f"(format {fmt})" in out and "Difference between" in out
    # the refined solve builds its low-precision twin the same way
    with monkeypatch.context() as m:
        m.setattr(cli, "init_matrix", no_host)
        assert cli.main(argv + ["--refine"]) == 0
    assert "Refinement:" in capsys.readouterr().out


def test_cli_generated_crs_solves_as_the_host_build(capsys):
    argv = ["-t", "cg", "-x", "10", "-y", "9", "-z", "7", "-i", "40",
            "--dtype", "f64", "--device", "cpu"]
    assert cli.main(argv + ["--fmt", "crs"]) == 0
    device_built = capsys.readouterr().out
    A = from_csr("crs", generate_stencil(10, 9, 7),
                 DTypePolicy.from_names("f64"), device=CPU)
    _x0, b, _xe = cg.init_vectors(generate_stencil(10, 9, 7))
    res = cg.solve_cg(A, b, itermax=40, verbose=False)
    for line in device_built.splitlines():
        if line.startswith("Difference between"):
            assert float(line.split("=")[1]) == pytest.approx(
                float(np.max(np.abs(res.x - 1.0))), abs=1e-6)
            break
    else:
        raise AssertionError("no difference line")


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K14 has no CPU mode)")
    return torch.device("cuda")


def random_csr(nr, nc, density, seed, empty_every=0):
    """A CSR with binomial row lengths, sorted columns, normal values; every
    ``empty_every``-th row empty."""
    rng = np.random.default_rng(seed)
    lens = rng.binomial(nc, density, nr)
    if empty_every:
        lens[::empty_every] = 0
    ptr = np.zeros(nr + 1, dtype=np.int64)
    np.cumsum(lens, out=ptr[1:])
    col = np.concatenate([np.sort(rng.choice(nc, n, replace=False))
                          for n in lens] + [np.zeros(0, dtype=np.int64)])
    return HostCSR(row_ptr=ptr, col=col.astype(np.int64),
                   val=rng.standard_normal(int(ptr[-1])), nr=nr, nc=nc)


def assert_within_sum_bound(A, x, y):
    """y against the plain version to 2 len_i u (|A| |x|)_i, row by row."""
    yt = crs_spmv_torch(A.val, A.col, A.row_ptr, x)
    assert y.dtype == yt.dtype == A.val.dtype and y.shape == yt.shape
    lens = (A.row_ptr[1:] - A.row_ptr[:-1]).double()
    absy = crs_spmv_torch(A.val.double().abs(), A.col, A.row_ptr,
                          x.double().abs())
    bound = 2 * lens * UNIT[A.val.dtype] * absy
    gap = (y.double() - yt.double()).abs()
    assert bool((gap <= bound).all()), float((gap - bound).max())


def k14_calls(A, x):
    before = crs_spmv.launches
    y = A.spmv(x)
    return y, crs_spmv.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("case", ["n1", "n1001", "100^3", "200^3"])
def test_k14_matches_the_plain_version(case, dt, cuda_device):
    policy = DTypePolicy.from_names(dt)
    if case == "n1":
        A = from_csr("crs", random_csr(1, 1, 1.0, 1), policy,
                     device=cuda_device)
    elif case == "n1001":
        A = from_csr("crs", random_csr(1001, 1001, 0.02, 2), policy,
                     device=cuda_device)
    else:
        n = int(case[:3])
        A, _ = CRSMatrix.from_stencil(n, n, n, device=cuda_device,
                                      policy=policy)
    assert A.impl == "kernel"
    x = torch.rand(A.nc, generator=torch.Generator().manual_seed(5),
                   dtype=policy.value).to(cuda_device)
    y, launched = k14_calls(A, x)
    assert launched == 1
    assert_within_sum_bound(A, x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_k14_on_uneven_rows(dt, cuda_device):
    """The test matrices' uneven rows, a CSR with every third row empty,
    and rows longer than a staged chunk."""
    policy = DTypePolicy.from_names(dt)
    cases = [read_mm(str(p)) for p in sorted(
        (DATA / "testMatrices").glob("*.mtx"))]
    cases += [random_csr(3000, 2000, 0.005, 3, empty_every=3),
              random_csr(40, 100000, 0.2, 4)]
    for csr in cases:
        A = from_csr("crs", csr, policy, device=cuda_device)
        x = torch.from_numpy(np.random.default_rng(csr.nr).standard_normal(
            csr.nc)).to(device=cuda_device, dtype=policy.value)
        y, launched = k14_calls(A, x)
        assert launched == (1 if csr.nnz else 0)
        assert_within_sum_bound(A, x, y)
        if csr.nnz:
            empty = (A.row_ptr[1:] == A.row_ptr[:-1])
            assert bool((y[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("value,index,vectors", [
    ("bf16", "i32", "bf16"), ("bf16", "i32", "f32"), ("f32", "i32", "f64"),
    ("f64", "i32", "f32"), ("f32", "i64", "f32"), ("f64", "i64", "f64")])
def test_other_dtypes_keep_the_plain_path(value, index, vectors, cuda_device):
    """bf16, mixed dtypes and int64 indices: no K14 launch, the plain
    version's result bit for bit, the span says torch."""
    policy = DTypePolicy.from_names(value, index)
    A, _ = CRSMatrix.from_stencil(9, 8, 7, device=cuda_device, policy=policy)
    x = torch.rand(A.nc, dtype=DTypePolicy.from_names(vectors).value,
                   device=cuda_device)
    assert not kernel_applies(A.val, A.col, A.row_ptr, x)
    y, launched = k14_calls(A, x)
    assert launched == 0
    assert torch.equal(y, crs_spmv_torch(A.val, A.col, A.row_ptr, x))
    profiler.RECORDER.clear()
    profiler.set_mode("on")
    try:
        A.spmv(x)
        assert profiler.spans()[-1].attrs["kernel"] == "torch"
    finally:
        profiler.set_mode("auto")
        profiler.RECORDER.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_a_strided_x_still_launches_k14(dt, cuda_device):
    """The layout of x never sends the SpMV to the plain version: a strided
    x launches K14 on a contiguous copy, to the contiguous x's bits, and
    the span says K14; an x of another shape raises."""
    policy = DTypePolicy.from_names(dt)
    A, _ = CRSMatrix.from_stencil(9, 8, 7, device=cuda_device, policy=policy)
    wide = torch.rand(A.nc, 3, dtype=policy.value, device=cuda_device)
    x = wide[:, 1]
    assert not x.is_contiguous()
    assert kernel_applies(A.val, A.col, A.row_ptr, x)
    y, launched = k14_calls(A, x)
    assert launched == 1
    assert torch.equal(y, A.spmv(x.contiguous()))
    assert_within_sum_bound(A, x, y)
    profiler.RECORDER.clear()
    profiler.set_mode("on")
    try:
        A.spmv(x)
        assert profiler.spans()[-1].attrs["kernel"] == "K14"
    finally:
        profiler.set_mode("auto")
        profiler.RECORDER.clear()
    before = crs_spmv.launches
    with pytest.raises(ValueError, match="crs_spmv"):
        A.spmv(wide)
    assert crs_spmv.launches == before


@pytest.mark.cuda
def test_card_build_equals_the_host_build(cuda_device):
    A, counts = CRSMatrix.from_stencil(37, 29, 23, device=cuda_device,
                                       policy=DTypePolicy.from_names("f32"))
    B = from_csr("crs", generate_stencil(37, 29, 23),
                 DTypePolicy.from_names("f32"), device=cuda_device)
    for f in ("row_ptr", "col", "val"):
        assert torch.equal(getattr(A, f), getattr(B, f)), f
    profiler.RECORDER.clear()
    profiler.set_mode("on")
    try:
        A.spmv(torch.ones(A.nc, device=cuda_device))
        s = profiler.spans()[-1]
        assert s.name == "crs.spmv" and s.attrs == {
            "kernel": "K14", "nnz": A.nnz, "row_ptr": "i32"}
        assert profiler.counts()["crs_spmv.launches"] == 1
    finally:
        profiler.set_mode("auto")
        profiler.RECORDER.clear()


@pytest.mark.cuda
def test_cg_200_cubed_through_k14_and_k13_matches_the_reference(cuda_device):
    """150 f32 iterations at 200^3 on seeded b = A x*: K14 and the fused
    body run every body, k is 150 and the history is the f64 reference's
    to rtol 1e-4 where that is at least 1e-4 of its start."""
    cfg = grid_cfg((200, 200, 200), itermax=150)
    A, _ = CRSMatrix.from_stencil(200, 200, 200, device=cuda_device,
                                  policy=DTypePolicy.from_names("f32"))
    xs = torch.rand(A.nr, generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64).to(cuda_device)
    b64 = hpcg.apply(xs, cfg)
    before = (crs_spmv.launches, profiler.kernels()["K15"].launches)
    x, k, hist = cg.cg_loop(A, b64.float(), torch.zeros_like(b64.float()),
                            150, 0.0)
    assert crs_spmv.launches - before[0] == 150
    assert profiler.kernels()["K15"].launches - before[1] == 3 * 149 + 1
    _x_ref, k_ref, h_ref = hpcg.cg(b64[None], cfg)
    assert int(k) == int(k_ref[0]) == 150
    h, h_ref = hist.double().cpu().numpy(), h_ref[:, 0].cpu().numpy()
    sel = h_ref >= 1e-4 * h_ref[0]
    assert sel[:2].all()
    np.testing.assert_allclose(h[sel], h_ref[sel], rtol=1e-4)


@pytest.mark.cuda
def test_a_body_launches_k14_and_the_three_kernels(cuda_device):
    """Per body: one K14 and one launch each of K15's A, B and C (and one
    K14 and one C a solve for its start), counted by the wrappers."""
    A, _ = CRSMatrix.from_stencil(32, 32, 32, device=cuda_device,
                                  policy=DTypePolicy.from_names("f32"))
    b = torch.rand(A.nr, device=cuda_device)
    x0 = torch.zeros_like(b)
    wrappers = (crs_spmv, cg_multi_body.body_rr, cg_multi_body.body_p,
                cg_multi_body.body_pap, cg_multi_body.body_xr)
    for itermax in (10, 20):
        before = [w.launches for w in wrappers]
        cg.cg_loop(A, b, x0, itermax, 0.0)
        bodies = itermax - 1
        ran = [w.launches - n for w, n in zip(wrappers, before)]
        assert ran == [bodies + 1, 1, bodies, bodies, bodies]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("n", [100, 200])
def test_wide_form_equals_the_narrow_form(n, dt, cuda_device):
    """The same matrix with its row pointers widened to int64 launches
    K14's wide form, which sums each row in the narrow form's order: the
    two results are equal bit for bit, and only the wide launch counts
    ``crs_spmv.wide``."""
    policy = DTypePolicy.from_names(dt)
    A, _ = CRSMatrix.from_stencil(n, n, n, device=cuda_device, policy=policy)
    assert A.row_ptr.dtype == torch.int32
    wide_ptr = A.row_ptr.long()
    x = torch.rand(A.nc, generator=torch.Generator().manual_seed(n),
                   dtype=policy.value).to(cuda_device)
    profiler.RECORDER.clear()
    profiler.set_mode("on")
    try:
        before = crs_spmv.launches
        narrow = crs_spmv(A.val, A.col, A.row_ptr, x)
        assert profiler.counts().get("crs_spmv.wide") is None
        assert kernel_applies(A.val, A.col, wide_ptr, x)
        wide = crs_spmv(A.val, A.col, wide_ptr, x)
        torch.cuda.synchronize()
        assert crs_spmv.launches - before == 2
        assert profiler.counts()["crs_spmv.wide"] == 1
        assert profiler.counts()["crs_spmv.launches"] == 2
    finally:
        profiler.set_mode("auto")
        profiler.RECORDER.clear()
    assert wide.dtype == narrow.dtype == policy.value
    assert torch.equal(wide, narrow)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_k14_wide_at_440_cubed_past_2_31_entries(dt, cuda_device):
    """The stencil at 440^3: 2,289,529,432 entries, so int64 row pointers
    and int32 columns, and one launch of K14's wide form. Every row, those
    whose entries lie past 2^31 - 1 among them, is within the bound of its
    sum, 2 len_i u (|A| |x|)_i, of the f64 reference's product."""
    cfg = grid_cfg((440, 440, 440))
    policy = DTypePolicy.from_names(dt)
    A, counts = CRSMatrix.from_stencil(440, 440, 440, device=cuda_device,
                                       policy=policy)
    assert A.nnz == 1318 ** 3 == 2_289_529_432
    assert A.row_ptr.dtype == torch.int64 and A.col.dtype == torch.int32
    x = torch.rand(A.nc, generator=torch.Generator(cuda_device)
                   .manual_seed(440), dtype=policy.value, device=cuda_device)
    y, launched = k14_calls(A, x)
    assert launched == 1
    past = int(torch.searchsorted(A.row_ptr, 2**31 - 1, right=True)) - 1
    assert 0 < past < A.nr - 1
    del A
    y_ref = hpcg.apply(x.double(), cfg)
    absy = hpcg.apply(x.double(), dict(cfg, off_diagonal=1.0))
    lens = torch.from_numpy(counts).to(cuda_device).double()
    gap = (y.double() - y_ref).abs() - 2 * lens * UNIT[policy.value] * absy
    assert float(gap.max()) <= 0.0
    assert float(gap[past:].max()) <= 0.0
