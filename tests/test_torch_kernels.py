"""The kernels of sparsebench_tpu_torch (the DIA SpMV K1; the stencil's
K2-K5; the bslab SpMV K6 and its windowed form K7; the multi-RHS DIA
product K8; the bsell SpMV K9 and its windowed forms K10 and K11; the read
ceiling K12): their wrappers, their build and, on a CUDA card, the kernels
themselves — without the JAX package.

Here on the CPU the dispatch, the refusals and the build lookup run; the
tests marked ``cuda`` skip without a card. On a machine with an NVIDIA
GPU and nvcc, which need not be able to import the JAX package, run the
whole file with

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider

(``--noconftest``: tests/conftest.py sets up JAX for the other tests).

The DIA kernel rounds each product and sum in the plain version's order,
so the stated bound ndiag * eps * (|A||x|)_i — any summation order, with or
without FMA contraction — is expected to hold with equality at 0. The
stencil kernels do the same, and their elementwise outputs are held to be
bit-identical to the plain versions; their dots, summed per block, are
held against their exact value to the bound of that summation,
(2 ceil(log2 n) + 64) eps sum|terms|. K6 and K7 sum each output's slices
in the plain version's order with each operation rounded on its own, and
are held to be bit-identical to it. K8 sums each column as K1 does and is
held to be bit-identical to its plain version and, column by column, to
K1. K9-K11 sum each output's slices in stored order, each operation rounded
on its own, and are held to be bit-identical to their plain version. K12
adds in the plain version's step order, each add rounded on its own, and
is held to be bit-identical to it.
"""

import math

import numpy as np
import pytest
import torch

from sparsebench_tpu_torch import cli
from sparsebench_tpu_torch.config import DTypePolicy, resolve_device
from sparsebench_tpu_torch.formats import from_csr, get_format
from sparsebench_tpu_torch.formats.bsell import BsellMatrix
from sparsebench_tpu_torch.formats.bslab import BslabMatrix
from sparsebench_tpu_torch.formats.dia import DiaMatrix, resolve_impl
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.formats.stencil import StencilOperator
from sparsebench_tpu_torch.host import HostCSR, generate_stencil, read_mm
from sparsebench_tpu_torch.ops import bsell_spmv as bsell_ops
from sparsebench_tpu_torch.ops.bslab_spmv import (
    bslab_spmv,
    bslab_spmv_torch,
    bslab_spmv_win,
    win_plan,
)
from sparsebench_tpu_torch.ops.cg_fused import cs_update, cs_update_torch
from sparsebench_tpu_torch.ops.dia_spmm import (
    STAGED,
    Window,
    aligned_shift,
    dia_spmm,
    dia_spmm_torch,
    march_plane,
    ring_bytes,
    segments,
    spmm_plan,
    staged_plan,
    windows_of,
)
from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_torch
from sparsebench_tpu_torch.ops.memroof import (
    measure_dma_read_gbps,
    read_passes,
    read_passes_torch,
)
from sparsebench_tpu_torch.ops import stencil as stencil_ops
from sparsebench_tpu_torch.ops.stencil import (
    stencil_apply,
    stencil_apply_dots,
    stencil_apply_dots_torch,
    stencil_apply_torch,
    stencil_axpy_apply_dots,
    stencil_axpy_apply_dots_torch,
)
from sparsebench_tpu_torch.ops.stencil_cg_vmem import (
    stencil_cg_vmem,
    stencil_cg_vmem_torch,
    vmem_cg_viable,
)
from sparsebench_tpu_torch.solvers import cg

CPU = torch.device("cpu")
DT = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
PAIRS = [("bf16", "f32"), ("f32", "f32"), ("f64", "f64")]


# -- on the CPU ------------------------------------------------------------


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor goes to the plain version and launches nothing."""
    A, _ = DiaMatrix.from_stencil(7, 6, 5, policy=DTypePolicy.from_names("f32"),
                                  device=CPU)
    x = torch.from_numpy(
        np.random.default_rng(1).standard_normal(A.nr).astype(np.float32))
    before = dia_spmv.launches
    y = dia_spmv(A.data, x, A.offsets, A.nr)
    assert dia_spmv.launches == before
    assert torch.equal(y, dia_spmv_torch(A.data, x, A.offsets, A.nr))


def test_plain_version_masks_the_edges():
    """Offsets reaching past x read zeros, like the JAX package's padded x."""
    data = torch.ones((3, 128), dtype=torch.float64)
    x = torch.arange(1.0, 6.0, dtype=torch.float64)
    y = dia_spmv_torch(data, x, (-7, 0, 2), 5)
    assert y.tolist() == [1 + 3, 2 + 4, 3 + 5, 4, 5]


def test_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Off the CPU the wrapper launches the kernel or raises: no fallback."""
    data = torch.zeros((1, 128), device="meta")
    x = torch.zeros(128, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        dia_spmv(data, x, (0,), 128)


def test_impl_and_device_resolution(monkeypatch):
    assert resolve_impl("auto", CPU) == "torch"
    assert resolve_impl("torch", CPU) == "torch"
    assert resolve_impl("auto", torch.device("cuda")) == "kernel"
    with pytest.raises(ValueError, match="kernel"):
        resolve_impl("kernel", CPU)
    with pytest.raises(ValueError, match="unknown"):
        resolve_impl("pallas", CPU)
    with pytest.raises(ValueError):
        DiaMatrix.from_stencil(4, 4, 4, device=CPU, impl="kernel")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == CPU


def test_registry_names_roadmap_item():
    assert get_format("dia") is DiaMatrix
    assert get_format("bslab") is BslabMatrix
    assert get_format("bsell") is BsellMatrix  # ported (Queue 1 item 10)
    with pytest.raises(ValueError, match="unknown"):
        get_format("nope")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises, it does not fall back or leave a library."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(FileNotFoundError, match="nvcc"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    """A library is named after its source and rebuilt when the source or
    a shared header changes; another source's library keeps its name."""
    src = tmp_path / "k.cu"
    other = tmp_path / "m.cu"
    header = tmp_path / "common.cuh"
    for f in (src, other, header):
        f.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path(src)
    assert first == _build.library_path(src)
    assert first.name.startswith("libk_")
    other_name = _build.library_path(other)
    src.write_text("// two\n")
    assert _build.library_path(src) != first
    assert _build.library_path(other) == other_name
    header.write_text("// two\n")
    assert _build.library_path(other) != other_name
    assert _build.library_path(src).parent == _build.BUILD_DIR


def test_kernel_sources_are_found():
    assert [p.name for p in _build.sources()] == [
        "bsell_spmv.cu", "bslab_spmv.cu", "cg_fused.cu",
        "cg_multi_body.cu", "crs_spmv.cu", "csr_twopass.cu",
        "dia_spmm.cu", "dia_spmv.cu", "dia_window.cu", "memroof.cu",
        "slab_slices.cu", "stencil.cu", "stencil_cg_vmem.cu"]
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


STENCIL_CASES = [((10, 9, 7), False), ((8, 8, 8), True), ((1, 1, 1), False),
                 ((130, 2, 3), False), ((128, 5, 4), True), ((1, 5, 6), False)]
# the kernels' cases: those, the other edge shapes of chip_smoke.py phase 3b
# and the main path's 100^3 and 200^3
KERNEL_STENCIL_CASES = STENCIL_CASES + [
    ((37, 29, 23), False), ((37, 29, 23), True), ((64, 8, 3), False),
    ((64, 8, 3), True), ((2, 2, 2), False), ((2, 2, 2), True),
    ((1, 5, 6), True), ((130, 2, 3), True), ((100, 100, 100), False),
    ((100, 100, 100), True), ((200, 200, 200), False),
    ((200, 200, 200), True)]


def stencil_launches():
    return (stencil_apply.launches, stencil_apply_dots.launches,
            stencil_axpy_apply_dots.launches, cs_update.launches,
            stencil_cg_vmem.launches)


@pytest.mark.parametrize("case", STENCIL_CASES)
def test_stencil_plain_apply_matches_the_generated_matrix(case):
    """The plain apply against the generator's own matrix (host.py),
    27 and 7 points, thin and single-point grids; f64 to 1e-13 of
    (|A||x|)_i."""
    (nx, ny, nz), use_7pt = case
    csr = generate_stencil(nx, ny, nz, use_7pt=use_7pt)
    dense = np.zeros((csr.nr, csr.nc))
    rows = np.repeat(np.arange(csr.nr), csr.row_lengths)
    dense[rows, csr.col] = csr.val
    x = np.random.default_rng(6).standard_normal(csr.nr)
    got = stencil_apply_torch(torch.from_numpy(x), nx, ny, nz, use_7pt)
    bound = np.abs(dense) @ np.abs(x)
    assert (np.abs(got.numpy() - dense @ x) <= 1e-13 * bound).all()
    A, counts = StencilOperator.from_stencil(nx, ny, nz, use_7pt=use_7pt,
                                             device=CPU)
    np.testing.assert_array_equal(counts, csr.row_lengths)
    assert A.nnz == csr.nnz


def test_stencil_wrappers_on_cpu_are_the_plain_versions():
    """CPU tensors go to the plain versions and launch nothing."""
    rng = np.random.default_rng(1)
    dims = (7, 6, 5)
    n = 210
    r, p, u, w, s, x = (torch.from_numpy(rng.standard_normal(n))
                        for _ in range(6))
    before = stencil_launches()
    assert torch.equal(stencil_apply(r, *dims), stencil_apply_torch(r, *dims))
    for a, b in zip(stencil_apply_dots(r, *dims, True),
                    stencil_apply_dots_torch(r, *dims, True)):
        assert torch.equal(a, b)
    for a, b in zip(stencil_axpy_apply_dots(r, p, 0.5, *dims),
                    stencil_axpy_apply_dots_torch(r, p, 0.5, *dims)):
        assert torch.equal(a, b)
    for a, b in zip(cs_update(u, p, w, s, x, r, 0.3, 0.7),
                    cs_update_torch(u, p, w, s, x, r, 0.3, 0.7)):
        assert torch.equal(a, b)
    for a, b in zip(stencil_cg_vmem(r, x, 0.0, *dims, 12),
                    stencil_cg_vmem_torch(r, x, 0.0, *dims, 12)):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert stencil_launches() == before


def test_stencil_wrappers_refuse_non_cpu_non_cuda_tensors():
    x = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        stencil_apply(x, 2, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        stencil_axpy_apply_dots(x, torch.zeros(8), 1.0, 2, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cs_update(*(torch.zeros(8, device="meta"),) * 6, 1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        stencil_cg_vmem(x, x, 0.0, 2, 2, 2, 5)


def test_stencil_operator_guards():
    with pytest.raises(ValueError, match="matrix-free"):
        StencilOperator.from_csr(None)
    with pytest.raises(ValueError, match="serial-only"):
        StencilOperator.from_stencil(4, 4, 4, rank=1, size=2, device=CPU)
    with pytest.raises(ValueError, match="kernel"):
        StencilOperator.from_stencil(4, 4, 4, device=CPU, impl="kernel")
    A, _ = StencilOperator.from_stencil(4, 4, 4, device=CPU)
    assert A.impl == "torch" and A.device == CPU
    assert get_format("stencil") is StencilOperator
    from sparsebench_tpu_torch.formats.base import physical_spmv_bytes

    assert physical_spmv_bytes(A, 4) == (A.nr + A.nc) * 4


def test_vmem_viability_plan():
    """On the CPU the JAX package's conservative plan: 100^3 fits, 200^3
    does not, and asking for it raises. On CUDA every grid whose five
    vectors fit the card: 200^3 in f32 and f64 on an 80 GB card, not 2000^3
    in f64."""
    assert vmem_cg_viable(100, 100, 100, 4)
    assert vmem_cg_viable(100, 100, 100, 8)
    assert not vmem_cg_viable(200, 200, 200, 4)
    for itemsize in (4, 8):
        assert vmem_cg_viable(200, 200, 200, itemsize, "cuda", 80 * 10**9)
    assert not vmem_cg_viable(2000, 2000, 2000, 8, "cuda", 80 * 10**9)
    assert not vmem_cg_viable(200, 200, 200, 4, "cuda", 10**8)
    with pytest.raises(ValueError, match="not viable at 200x200x200"):
        stencil_cg_vmem_torch(torch.zeros(8), torch.zeros(8), 0.0,
                              200, 200, 200, 5)


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def assert_kernel_matches_plain(data, x, offsets, nr):
    before = dia_spmv.launches
    y = dia_spmv(data, x, offsets, nr)
    assert dia_spmv.launches == before + 1
    y_ref = dia_spmv_torch(data, x, offsets, nr)
    bound = dia_spmv_torch(data.abs(), x.abs(), offsets, nr)
    tol = len(offsets) * torch.finfo(x.dtype).eps
    assert bool(torch.isfinite(y).all())
    assert bool(((y - y_ref).abs() <= tol * bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
def test_kernel_matches_plain_on_stencil(pair, cuda_device):
    A, _ = DiaMatrix.from_stencil(10, 9, 7, policy=DTypePolicy.from_names("f32"),
                                  device=cuda_device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(A.nr)).to(
        device=cuda_device, dtype=DT[pair[1]])
    assert_kernel_matches_plain(A.data.to(DT[pair[0]]), x, A.offsets, A.nr)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("offsets,nr", [((-1000, -1, 0, 1, 999), 8192),
                                        ((-257, 0, 257), 5000), ((0,), 1),
                                        ((-3, 5), 7)])
def test_kernel_matches_plain_on_edge_offsets(pair, offsets, nr,
                                              cuda_device):
    rng = np.random.default_rng(nr)
    data = torch.from_numpy(rng.standard_normal((len(offsets), max(nr, 128))))
    x = torch.from_numpy(rng.standard_normal(nr))
    assert_kernel_matches_plain(
        data.to(device=cuda_device, dtype=DT[pair[0]]),
        x.to(device=cuda_device, dtype=DT[pair[1]]), offsets, nr)


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    data = torch.zeros((2, 256), device=cuda_device)
    x = torch.zeros(256, device=cuda_device)
    with pytest.raises(TypeError, match="no kernel"):
        dia_spmv(data, x.double(), (0, 1), 256)
    with pytest.raises(ValueError, match="ndiag"):
        dia_spmv(data, x, (0,), 256)
    with pytest.raises(ValueError, match="nr"):
        dia_spmv(data, x[:100], (0, 1), 200)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmv(data[:, ::2], x[:128], (0, 1), 128)
    with pytest.raises(ValueError, match="both"):
        dia_spmv(data, x.cpu(), (0, 1), 256)


@pytest.mark.cuda
def test_cg_through_the_kernel_equals_the_plain_version(cuda_device):
    """f64 CG at 12^3: the kernel and the plain version give the same k,
    history and x, bit for bit."""
    f64 = DTypePolicy.from_names("f64")
    results = []
    for impl in ("kernel", "torch"):
        A, counts = DiaMatrix.from_stencil(12, 12, 12, device=cuda_device,
                                           policy=f64, impl=impl)
        _x, b, xexact = cg.init_vectors(row_lengths=counts)
        results.append(cg.solve_cg(A, b, itermax=60, verbose=False))
    rk, rt = results
    assert rk.iterations == rt.iterations == 60
    np.testing.assert_array_equal(rk.residual_history, rt.residual_history)
    np.testing.assert_array_equal(rk.x, rt.x)
    assert cg.check_residual(rk.x, xexact) < 1e-10


@pytest.mark.cuda
def test_cli_default_device_runs_the_kernel(cuda_device, capsys):
    before = dia_spmv.launches
    assert cli.main(["-t", "cg", "-x", "16", "-y", "16", "-z", "16",
                     "-i", "30"]) == 0
    out = capsys.readouterr().out
    assert dia_spmv.launches - before == 2 * 30
    assert torch.cuda.get_device_name(cuda_device) in out
    assert "spmv kernel" in out and "Difference between" in out


def assert_bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a.view(torch.uint8) if a.dtype != torch.bfloat16
                       else a.view(torch.int16),
                       b.view(torch.uint8) if b.dtype != torch.bfloat16
                       else b.view(torch.int16))


def assert_dot_near_exact(got, terms, eps):
    """A kernel's dot against the exact sum of its f64 ``terms`` (the
    products it rounds at precision ``eps``), to the forward error bound of
    its summation: a 256-wide block tree, then torch.sum over the blocks,
    (2 ceil(log2 n) + 64) eps sum|terms| (chip_smoke.py's SUM_SERIAL)."""
    n = terms.numel()
    exact = math.fsum(terms.cpu().numpy())
    tol = (2 * math.ceil(math.log2(max(n, 2))) + 64) * eps * float(
        terms.abs().sum())
    assert abs(float(got) - exact) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f32", "f64"])
@pytest.mark.parametrize("case", KERNEL_STENCIL_CASES)
def test_stencil_apply_kernel_equals_plain(case, dt, cuda_device):
    """K2 and its dots form against the plain versions on the card."""
    dims, use_7pt = case
    n = dims[0] * dims[1] * dims[2]
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(n)).to(
        device=cuda_device, dtype=DT[dt])
    before = stencil_apply.launches
    y = stencil_apply(x, *dims, use_7pt)
    assert stencil_apply.launches == before + 1
    assert_bits_equal(y, stencil_apply_torch(x, *dims, use_7pt))
    yd, gd = stencil_apply_dots(x, *dims, use_7pt)
    y_ref, gd_ref = stencil_apply_dots_torch(x, *dims, use_7pt)
    assert_bits_equal(yd, y_ref)
    assert gd.dtype == torch.float32 and gd_ref.dtype == torch.float32
    xf = x.float().double()
    yf = stencil_apply_torch(x.to(torch.float64 if dt == "f64"
                                  else torch.float32), *dims,
                             use_7pt).float().double()
    eps = torch.finfo(torch.float32).eps
    assert_dot_near_exact(gd[0], xf * xf, eps)
    assert_dot_near_exact(gd[1], yf * xf, eps)


@pytest.mark.parametrize("dot", [0, 1])
def test_dots_bound_holds_and_catches_a_wrong_reduction(dot):
    """The dots bound at 100^3 in f32: the plain version's dots lie inside
    it, and a reduction that drops one 256-point block, or sums one twice,
    lies outside it."""
    dims = (100, 100, 100)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(10**6)).to(
        torch.float32)
    y, gd = stencil_apply_dots_torch(x, *dims)
    xd, yd = x.double(), y.double()
    terms = (xd * xd, yd * xd)[dot]
    eps = torch.finfo(torch.float32).eps
    assert_dot_near_exact(gd[dot], terms, eps)
    block = float(terms[256 * 1000:256 * 1001].sum())
    for wrong in (float(gd[dot]) - block, float(gd[dot]) + block):
        with pytest.raises(AssertionError):
            assert_dot_near_exact(wrong, terms, eps)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f32", "f64"])
@pytest.mark.parametrize("case", KERNEL_STENCIL_CASES)
def test_stencil_axpy_apply_dots_kernel_equals_plain(case, dt, cuda_device):
    """K3: p' and w bit for bit, delta to its summation bound around the
    exact sum of w p' at the compute width."""
    dims, use_7pt = case
    n = dims[0] * dims[1] * dims[2]
    rng = np.random.default_rng(n + 1)
    r, p = (torch.from_numpy(rng.standard_normal(n)).to(
        device=cuda_device, dtype=DT[dt]) for _ in range(2))
    beta = torch.tensor(0.61, device=cuda_device)
    before = stencil_axpy_apply_dots.launches
    pn, w, d = stencil_axpy_apply_dots(r, p, beta, *dims, use_7pt)
    assert stencil_axpy_apply_dots.launches == before + 1
    pn_ref, w_ref, d_ref = stencil_axpy_apply_dots_torch(r, p, beta, *dims,
                                                         use_7pt)
    assert_bits_equal(pn, pn_ref)
    assert_bits_equal(w, w_ref)
    assert d.dtype == d_ref.dtype
    cdt = d.dtype
    pn_c, w_c, _ = stencil_axpy_apply_dots_torch(r.to(cdt), p.to(cdt), beta,
                                                 *dims, use_7pt)
    assert_dot_near_exact(d, (w_c * pn_c).double(), torch.finfo(cdt).eps)


@pytest.mark.cuda
@pytest.mark.parametrize("r,tz", [(1, 1), (1, 32), (2, 3), (2, 16), (4, 8),
                                  (8, 1), (8, 4)])
@pytest.mark.parametrize("dims", [(100, 100, 100), (37, 29, 23),
                                  (130, 2, 3), (2, 2, 2)])
def test_stencil_kernels_under_forced_plans(dims, r, tz, cuda_device):
    """K2, its dots form and K3 bit for bit under forced tile plans, every
    R the kernels are built for, 27- and 7-point, f32 and f64; the dots'
    partials are one a block of the plan."""
    n = dims[0] * dims[1] * dims[2]
    rng = np.random.default_rng(r * 100 + tz)
    for dt in ("f32", "f64"):
        x, rv, p = (torch.from_numpy(rng.standard_normal(n)).to(
            device=cuda_device, dtype=DT[dt]) for _ in range(3))
        plan = stencil_ops.tile_plan(*dims, x.element_size(), 132, r=r, tz=tz)
        for use_7pt in (False, True):
            want = stencil_apply_torch(x, *dims, use_7pt)
            assert_bits_equal(stencil_apply(x, *dims, use_7pt, plan), want)
            y, parts = stencil_ops._launch_apply(x, *dims, use_7pt, True,
                                                 plan)
            assert_bits_equal(y, want)
            assert parts.shape == (plan.grid, 2)
            pn, w, parts3 = stencil_ops._launch_axpy(rv, p, 0.8, *dims,
                                                     use_7pt, plan)
            pn_ref, w_ref, _ = stencil_axpy_apply_dots_torch(rv, p, 0.8,
                                                             *dims, use_7pt)
            assert_bits_equal(pn, pn_ref)
            assert_bits_equal(w, w_ref)
            assert parts3.shape == (plan.grid,)
            assert_dot_near_exact(parts3.sum(), (w.double() * pn.double()),
                                  torch.finfo(x.dtype).eps)


@pytest.mark.cuda
def test_stencil_kernels_refuse_a_plan_that_does_not_fit(cuda_device):
    """The C entry points check the plan against the grid: a wrong grid,
    wrong shared bytes, an R they are not built for or the plan of another
    grid is refused before anything launches."""
    import dataclasses

    dims = (37, 29, 23)
    x = torch.zeros(37 * 29 * 23, device=cuda_device)
    plan = stencil_ops.tile_plan(*dims, 4, 132)
    for bad in (dataclasses.replace(plan, grid=plan.grid + 1),
                dataclasses.replace(plan, smem=plan.smem + 4),
                dataclasses.replace(plan, r=3),
                stencil_ops.tile_plan(70, 29, 23, 4, 132, r=1, tz=1)):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            stencil_apply(x, *dims, False, bad)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            stencil_axpy_apply_dots(x, x, 1.0, *dims, True, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["bf16", "f32", "f64"])
@pytest.mark.parametrize("n", [1, 1000, 8192, 1_000_003])
def test_cs_update_kernel_equals_plain(n, dt, cuda_device):
    rng = np.random.default_rng(n)
    vecs = [torch.from_numpy(rng.standard_normal(n)).to(
        device=cuda_device, dtype=DT[dt]) for _ in range(6)]
    al = torch.tensor(0.37, device=cuda_device)
    be = torch.tensor(-1.25, device=cuda_device)
    before = cs_update.launches
    got = cs_update(*vecs, al, be)
    assert cs_update.launches == before + 1
    for g, w in zip(got, cs_update_torch(*vecs, al, be)):
        assert_bits_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("dims,use_7pt,eps,forced", [
    ((10, 9, 8), False, 0.0, None), ((8, 8, 8), True, 1e-8, None),
    ((40, 30, 20), False, 0.0, None), ((100, 100, 100), False, 0.0, None),
    ((37, 29, 23), False, 0.0, None), ((64, 8, 3), False, 0.0, None),
    ((130, 2, 3), True, 0.0, None), ((2, 2, 2), False, 0.0, None),
    ((1, 1, 1), False, 0.0, None), ((200, 200, 200), False, 0.0, None),
    # forced plans: fewer tiles than blocks, and many more
    ((100, 100, 100), False, 0.0, (2, 16)), ((100, 100, 100), True, 0.0,
                                             (1, 1)),
    ((100, 100, 100), False, 0.0, (8, 4)),
    ((37, 29, 23), False, 0.0, (1, 1)), ((37, 29, 23), True, 0.0, (4, 2))])
def test_vmem_kernel_matches_plain(dims, use_7pt, eps, forced, dt,
                                   cuda_device):
    """K5 against its plain version: k equal, the history to rtol 1e-9
    (f64; 1e-4 in f32) above its noise floor, one launch per solve; on the
    default plan and on forced ones."""
    from sparsebench_tpu_torch.ops.stencil_cg_vmem import device_cg_plan

    A, counts = StencilOperator.from_stencil(*dims, use_7pt=use_7pt,
                                             device=cuda_device)
    b = torch.from_numpy(27.0 - (counts - 1.0)).to(cuda_device, DT[dt])
    x0 = torch.zeros_like(b)
    r0 = b - A.spmv(x0)
    plan = (device_cg_plan(r0, *dims, use_7pt, *forced) if forced else None)
    before = stencil_cg_vmem.launches
    x, h = stencil_cg_vmem(r0, x0, eps, *dims, 40, use_7pt, plan)
    assert stencil_cg_vmem.launches == before + 1
    x_ref, h_ref = stencil_cg_vmem_torch(r0, x0, eps, *dims, 40, use_7pt)
    h, h_ref = h.cpu().numpy(), h_ref.cpu().numpy()
    k, k_ref = int(np.sum(~np.isnan(h))), int(np.sum(~np.isnan(h_ref)))
    floor, rtol = (1e-10, 1e-9) if dt == "f64" else (1e-4, 1e-4)
    if dt == "f64":
        assert k == k_ref
    sel = h_ref[:k_ref] >= floor * h_ref[0]
    np.testing.assert_allclose(h[:k_ref][sel], h_ref[:k_ref][sel], rtol=rtol)
    assert bool(torch.isfinite(x).all())
    np.testing.assert_allclose(x.cpu().numpy(), x_ref.cpu().numpy(), rtol=0,
                               atol=1e-10 if dt == "f64" else 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("dims,use_7pt,x0_scale,eps,itermax,forced", [
    ((37, 29, 23), False, 0.0, 0.0, 30, None),
    ((130, 2, 3), True, 0.0, 0.0, 20, None),
    ((10, 9, 8), True, 0.1, 1e-8, 60, None),
    ((2, 2, 2), False, 0.0, 0.0, 8, None),
    ((37, 29, 23), False, 0.0, 0.0, 12, (8, 4)),
    ((37, 29, 23), True, 0.0, 0.0, 12, (1, 1)),
    ((100, 100, 100), False, 0.0, 0.0, 6, None)])
def test_vmem_kernel_equals_its_schedule(dims, use_7pt, x0_scale, eps,
                                         itermax, forced, dt, cuda_device):
    """K5 bit for bit against the CPU emulation of its schedule
    (tests/test_torch_stencil_cg_plan.py ``k5_emulate``) on the card's
    plan: the same p', w, r and x in every iteration and the same order of
    sums, so the same x and history."""
    from test_torch_stencil_cg_plan import k5_emulate, problem

    from sparsebench_tpu_torch.ops.stencil_cg_vmem import device_cg_plan

    r0, x0 = problem(dims, use_7pt, DT[dt], x0_scale)
    plan = device_cg_plan(r0.to(cuda_device), *dims, use_7pt,
                          *(forced or ()))
    x, h = stencil_cg_vmem(r0.to(cuda_device), x0.to(cuda_device), eps,
                           *dims, itermax, use_7pt, plan)
    x_e, h_e = k5_emulate(r0, x0, eps, dims, itermax, use_7pt, plan)
    assert_bits_equal(h.cpu(), h_e)
    assert_bits_equal(x.cpu(), x_e)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("dims,use_7pt,x0_scale,eps,itermax,force", [
    ((64, 8, 3), False, 0.0, 0.0, 20, {}),
    ((8, 8, 8), True, 0.0, 0.0, 20, {}),
    ((16, 9, 8), True, 0.1, 1e-8, 60, {}),
    ((24, 19, 11), False, 0.1, 0.0, 25, {"tz": 3}),
    ((1000, 7, 3), True, 0.0, 0.0, 25, {}),
    ((600, 9, 4), False, 0.0, 0.0, 25, {}),
    ((100, 100, 100), False, 0.0, 0.0, 6, {})])
def test_vmem_ring_equals_its_schedule(dims, use_7pt, x0_scale, eps,
                                       itermax, force, dt, cuda_device):
    """K5's ring form bit for bit against the CPU emulation of its
    schedule (``k5_emulate`` on the ring's plan: its tiles, items and
    order of sums), on the card's plan with the ring forced."""
    from test_torch_stencil_cg_plan import k5_emulate, problem

    from sparsebench_tpu_torch.ops.stencil_cg_vmem import device_cg_plan

    r0, x0 = problem(dims, use_7pt, DT[dt], x0_scale)
    plan = device_cg_plan(r0.to(cuda_device), *dims, use_7pt, form="ring",
                          **force)
    x, h = stencil_cg_vmem(r0.to(cuda_device), x0.to(cuda_device), eps,
                           *dims, itermax, use_7pt, plan)
    x_e, h_e = k5_emulate(r0, x0, eps, dims, itermax, use_7pt, plan)
    assert_bits_equal(h.cpu(), h_e)
    assert_bits_equal(x.cpu(), x_e)


@pytest.mark.cuda
def test_vmem_ring_refuses_a_plan_that_differs(cuda_device):
    """The C side recomputes the ring's plan: another grid, tile rows,
    shared bytes or form, and rows that are not whole 16-byte units, are
    refused before anything launches."""
    import dataclasses

    from sparsebench_tpu_torch.ops.stencil_cg_vmem import (
        device_cg_plan,
        ring_smem,
    )

    dims = (64, 8, 3)
    r0 = torch.ones(math.prod(dims), device=cuda_device)
    plan = device_cg_plan(r0, *dims, form="ring")
    for bad in (dataclasses.replace(plan, blocks=plan.blocks + 1),
                dataclasses.replace(plan, r=plan.r // 2,
                                    tile_y=plan.tile_y // 2),
                dataclasses.replace(plan, smem=plan.smem + 16),
                dataclasses.replace(plan, form="march")):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            stencil_cg_vmem(r0, r0, 0.0, *dims, 5, False, bad)
    odd = (37, 8, 3)  # a row of 148 B; its shared bytes as the ring's
    r1 = torch.ones(math.prod(odd), device=cuda_device)
    smem = ring_smem(37, plan.r, 4)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        stencil_cg_vmem(r1, r1, 0.0, *odd, 5, False,
                        dataclasses.replace(plan, tile_x=37, smem=smem))


@pytest.mark.cuda
def test_vmem_kernel_refuses_a_plan_that_differs(cuda_device):
    """The C side recomputes the plan: another grid, a tz or R the shared
    bytes do not match are refused before anything launches."""
    import dataclasses

    from sparsebench_tpu_torch.ops.stencil_cg_vmem import device_cg_plan

    dims = (37, 29, 23)
    r0 = torch.ones(math.prod(dims), device=cuda_device)
    plan = device_cg_plan(r0, *dims)
    for bad in (dataclasses.replace(plan, blocks=plan.blocks + 1),
                dataclasses.replace(plan, tz=0),
                dataclasses.replace(plan, r=2 if plan.r != 2 else 4)):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            stencil_cg_vmem(r0, r0, 0.0, *dims, 5, False, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["standard", "cs", "fused", "vmem"])
def test_cg_variant_through_the_kernels_equals_plain(variant, cuda_device,
                                                     monkeypatch):
    """f64 CG at 12^3 on the stencil: kernels and plain versions give the
    same k and history to rtol 1e-9 above 1e-10 of its start."""
    monkeypatch.setenv("SB_FUSED_CS", "1")
    results = []
    for impl in ("kernel", "torch"):
        A, counts = StencilOperator.from_stencil(12, 12, 12, device=cuda_device,
                                                 impl=impl)
        _x, b, xexact = cg.init_vectors(row_lengths=counts)
        results.append(cg.solve_cg(A, b, itermax=60, verbose=False,
                                   variant=variant))
    rk, rt = results
    assert rk.iterations == rt.iterations
    sel = rt.residual_history >= 1e-10 * rt.residual_history[0]
    np.testing.assert_allclose(rk.residual_history[sel],
                               rt.residual_history[sel], rtol=1e-9)
    assert cg.check_residual(rk.x, xexact) < 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("variant,kernels", [
    ("standard", (1, 0, 0, 0, 0)), ("cs", (1, 0, 0, 0, 0)),
    ("fused", (1, 0, 1, 0, 0)), ("vmem", (1, 0, 0, 0, 1)),
])
def test_cli_stencil_default_device_runs_the_kernels(variant, kernels,
                                                     cuda_device, capsys):
    before = stencil_launches()
    assert cli.main(["-t", "cg", "--fmt", "stencil", "--cg-variant", variant,
                     "-x", "16", "-y", "16", "-z", "16", "-i", "30"]) == 0
    out = capsys.readouterr().out
    ran = [a - b for a, b in zip(stencil_launches(), before)]
    assert [bool(v) for v in ran] == [bool(v) for v in kernels]
    if variant == "vmem":
        assert ran[4] == 2  # one launch per solve: warm-up and timed
    assert "| format stencil |" in out and "Difference between" in out


# -- K6 and K7, the bslab SpMV ------------------------------------------------

DATA = __import__("pathlib").Path(__file__).parent / "data"


def random_csr(nr, nc, density, seed):
    rng = np.random.default_rng(seed)
    r, c = np.nonzero(rng.random((nr, nc)) < density)
    row_ptr = np.zeros(nr + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=nr), out=row_ptr[1:])
    return HostCSR(row_ptr=row_ptr, col=c.astype(np.int64),
                   val=rng.standard_normal(r.size), nr=nr, nc=nc)


def bslab_case(name, device):
    """A BslabMatrix of each slice class mix (f32 policy)."""
    from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab

    f32 = DTypePolicy.from_names("f32")
    if name == "stencil":
        return BslabMatrix.from_stencil(10, 9, 7, device=device, policy=f32)[0]
    if name == "stencil_sub8":
        return BslabMatrix.from_stencil(8, 8, 20, device=device, policy=f32,
                                        sub=8)[0]
    if name == "klein":
        csr = read_mm(str(DATA / "matrix_band_klein.mtx"))
    elif name.startswith("test"):
        csr = read_mm(str(DATA / "testMatrices" / f"{name}.mtx"))
    elif name == "random":
        csr = random_csr(300, 420, 0.03, 1)
    else:  # RGL: exact caps, one wide pool, grouped pools of span 2
        opts = {"rgl": {}, "rgl_pool": dict(force_caps=(1,) * 3),
                "rgl_span2": dict(force_caps=(1,) * 3, force_span=2)}[name]
        return rgl_bslab(3000, band=128, deg=10.0, seed=11, sub=8,
                         device=device, policy=f32, **opts)[0]
    return BslabMatrix.from_csr(csr, f32, device=device, sub=8)


BSLAB_CASES = ["stencil", "stencil_sub8", "klein", "test0", "test8",
               "random", "rgl", "rgl_pool", "rgl_span2"]


def slices_as(A, td):
    sl = A.slices
    return sl._replace(vals_aff=sl.vals_aff.to(td), vals_gen=sl.vals_gen.to(td),
                       vals_wide=sl.vals_wide.to(td))


def test_bslab_plain_version_matches_the_host_csr():
    """The plain version on the CPU (what the kernels are held to) against
    the host CSR product, f64, every slice class."""
    from sparsebench_tpu_torch.host import rgl_csr

    A = bslab_case("rgl_span2", CPU)
    assert A.s_wide > 0 and A.s_gen > 0
    x = np.random.default_rng(0).standard_normal(A.nc)
    y = bslab_spmv_torch(slices_as(A, torch.float64), torch.from_numpy(x),
                         sub=A.sub, lead=A.lead, x_rows=A.x_rows)
    want = rgl_csr(3000, band=128, deg=10.0, seed=11).spmv(x)
    np.testing.assert_allclose(y.reshape(-1)[:A.nr].numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


def test_bslab_window_fit():
    """K7's unit holds two W-row chunks of x: one block where 2W rows fit
    its 227 KB, else the smallest cluster whose blocks hold a stripe each;
    the refusal, above a cluster of 8, names the size."""
    A = bslab_case("rgl", CPU)
    sl = A.slices
    assert win_plan(sl, A.w_blocks, torch.float32).cluster == 1
    assert win_plan(sl, 224, torch.float32).cluster == 1   # 100^3 at sub 64
    assert win_plan(sl, 224, torch.float64).cluster == 2
    assert win_plan(sl, 760, torch.float32).cluster == 4   # 200^3 at sub 128
    assert win_plan(sl, 760, torch.float64).cluster == 7
    with pytest.raises(ValueError, match="cluster of 8"):
        win_plan(sl, 4000, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("case", BSLAB_CASES)
def test_bslab_kernels_equal_plain(case, pair, cuda_device):
    """K6 and K7 against the plain version, bit for bit."""
    A = bslab_case(case, cuda_device)
    sl = slices_as(A, DT[pair[0]])
    x = torch.from_numpy(np.random.default_rng(A.nr).standard_normal(
        A.nc)).to(cuda_device, DT[pair[1]])
    y_ref = bslab_spmv_torch(sl, x, sub=A.sub, lead=A.lead, x_rows=A.x_rows)
    before = bslab_spmv.launches
    y = bslab_spmv(sl, x, sub=A.sub, lead=A.lead)
    assert bslab_spmv.launches == before + 1
    assert bool(torch.isfinite(y).all())
    assert_bits_equal(y, y_ref)
    before = bslab_spmv_win.launches
    y = bslab_spmv_win(A.wchunk, sl, x, sub=A.sub, lead=A.lead,
                       w_blocks=A.w_blocks)
    assert bslab_spmv_win.launches == before + 1
    assert_bits_equal(y, y_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("case", ["stencil", "klein", "rgl_span2"])
def test_bslab_win_forced_cluster_equals_plain(case, pair, cuda_device):
    """K7 with a forced cluster of 2 where one block would do: half of
    every chunk in the peer's shared memory, read through distributed
    shared memory, with a third ring slot; bit for bit."""
    A = bslab_case(case, cuda_device)
    sl = slices_as(A, DT[pair[0]])
    x = torch.from_numpy(np.random.default_rng(A.nr).standard_normal(
        A.nc)).to(cuda_device, DT[pair[1]])
    assert win_plan(sl, A.w_blocks, x.dtype).cluster == 1
    assert win_plan(sl, A.w_blocks, x.dtype, cluster=2).ring == 3
    y_ref = bslab_spmv_torch(sl, x, sub=A.sub, lead=A.lead, x_rows=A.x_rows)
    y = bslab_spmv_win(A.wchunk, sl, x, sub=A.sub, lead=A.lead,
                       w_blocks=A.w_blocks, cluster=2)
    assert_bits_equal(y, y_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
def test_bslab_kernels_at_200_cubed(pair, cuda_device):
    """The 200^3 stencil (W 760): K7's window spans a cluster of 4 blocks
    (f64: 7); K6 and K7 bit for bit against the plain version."""
    A = BslabMatrix.from_stencil(200, 200, 200, device=cuda_device,
                                 policy=DTypePolicy.from_names("f32"))[0]
    sl = slices_as(A, DT[pair[0]])
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        A.nc)).to(cuda_device, DT[pair[1]])
    plan = win_plan(sl, A.w_blocks, x.dtype)
    assert (A.w_blocks, plan.cluster) == (760, 4 if pair[1] == "f32" else 7)
    y_ref = bslab_spmv_torch(sl, x, sub=A.sub, lead=A.lead, x_rows=A.x_rows)
    assert_bits_equal(bslab_spmv(sl, x, sub=A.sub, lead=A.lead), y_ref)
    assert_bits_equal(bslab_spmv_win(A.wchunk, sl, x, sub=A.sub, lead=A.lead,
                                     w_blocks=A.w_blocks), y_ref)


@pytest.mark.cuda
def test_bslab_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    A = bslab_case("rgl_pool", cuda_device)
    x = torch.ones(A.nc, device=cuda_device)
    with pytest.raises(TypeError, match="no kernel"):
        bslab_spmv(A.slices, x.double(), sub=A.sub, lead=A.lead)
    with pytest.raises(ValueError, match="CUDA device"):
        bslab_spmv(A.slices, x.cpu(), sub=A.sub, lead=A.lead)
    with pytest.raises(ValueError, match="contiguous"):
        bslab_spmv(A.slices, x, sub=A.sub * 2, lead=A.lead)
    with pytest.raises(ValueError, match="shared memory a block in a "
                       "cluster of 8"):
        bslab_spmv_win(A.wchunk, A.slices, x, sub=A.sub, lead=A.lead,
                       w_blocks=4000)
    with pytest.raises(ValueError, match="cluster size"):
        bslab_spmv_win(A.wchunk, A.slices, x, sub=A.sub, lead=A.lead,
                       w_blocks=A.w_blocks, cluster=9)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,kernel", [("auto", "kernel"),
                                         ("kernel", "kernel"),
                                         ("kernel_win", "kernel_win")])
def test_bslab_cg_through_the_kernels_equals_plain(impl, kernel, cuda_device):
    """f64 CG on the RGL matrix with a random b: the kernel and the plain
    version give the same k and history, bit for bit."""
    from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab

    f64 = DTypePolicy.from_names("f64")
    b = np.random.default_rng(3).standard_normal(3000)
    results = []
    for which in (impl, "torch"):
        A, _ = rgl_bslab(3000, band=128, deg=10.0, seed=11, sub=8,
                         device=cuda_device, policy=f64, impl=which,
                         force_caps=(1,) * 3, force_span=2)
        assert A.impl == (kernel if which == impl else "torch")
        results.append(cg.solve_cg(A, b, itermax=40, verbose=False))
    rk, rt = results
    assert rk.iterations == rt.iterations == 40
    np.testing.assert_array_equal(rk.residual_history, rt.residual_history)
    np.testing.assert_array_equal(rk.x, rt.x)


@pytest.mark.cuda
@pytest.mark.parametrize("argv,kernel", [
    (["--fmt", "bslab", "-x", "16", "-y", "16", "-z", "16"], "K6"),
    (["--fmt", "sell", "-x", "16", "-y", "16", "-z", "16"], "K6"),
    (["-m", "generateRGL", "-x", "20000", "-y", "1", "-z", "1", "--band",
      "128"], "K6"),
    (["-m", "generateRGL", "-x", "20000", "-y", "1", "-z", "1", "--band",
      "128", "--impl", "kernel_win"], "K7"),
])
def test_cli_bslab_default_device_runs_the_kernels(argv, kernel, cuda_device,
                                                   capsys):
    before = (bslab_spmv.launches, bslab_spmv_win.launches)
    assert cli.main(["-t", "cg", "-i", "30", *argv]) == 0
    out = capsys.readouterr().out
    ran = (bslab_spmv.launches - before[0],
           bslab_spmv_win.launches - before[1])
    assert (ran[0] > 0, ran[1] > 0) == (kernel == "K6", kernel == "K7")
    assert "Difference between" in out


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["sell", "ell", "crs", "ccrs"])
def test_gather_formats_on_the_card_match_the_cpu(fmt, cuda_device):
    """SELL (bridged to bslab on the card), ELL, CRS and CCRS: the f64 SpMV
    on the card against the CPU's, and an f64 CG through it to x = 1."""
    csr = random_csr(300, 300, 0.03, 4)
    f64 = DTypePolicy.from_names("f64")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(300))
    A_c = from_csr(fmt, csr, f64, device=CPU)
    A_g = from_csr(fmt, csr, f64, device=cuda_device)
    assert (getattr(A_g, "fast", None) is not None) == (fmt == "sell")
    np.testing.assert_allclose(A_g.spmv(x.to(cuda_device)).cpu().numpy(),
                               A_c.spmv(x).numpy(), rtol=1e-13, atol=1e-13)
    stencil = generate_stencil(8, 8, 8)
    A = from_csr(fmt, stencil, f64, device=cuda_device)
    _x, b, xexact = cg.init_vectors(stencil)
    before = bslab_spmv.launches
    res = cg.solve_cg(A, b, itermax=60, verbose=False)
    assert cg.check_residual(res.x, xexact) < 1e-10
    assert (bslab_spmv.launches > before) == (fmt == "sell")


# -- K8: the multi-RHS DIA product ----------------------------------------------


def test_spmm_wrapper_on_cpu_is_the_plain_version():
    """A CPU block goes to the plain version and launches nothing; each of
    its rows is the single-vector product of that row, bit for bit."""
    A, _ = DiaMatrix.from_stencil(7, 6, 5, policy=DTypePolicy.from_names("f32"),
                                  device=CPU)
    X = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (5, A.nr)).astype(np.float32))
    before = dia_spmm.launches
    Y = dia_spmm(A.data, X, A.offsets, A.nr)
    assert dia_spmm.launches == before
    assert torch.equal(Y, dia_spmm_torch(A.data, X, A.offsets, A.nr))
    for c in range(5):
        assert torch.equal(Y[c], dia_spmv_torch(A.data, X[c], A.offsets, A.nr))


def test_spmm_plain_version_masks_the_edges():
    data = torch.ones((3, 128), dtype=torch.float64)
    X = torch.stack([torch.arange(1.0, 6.0, dtype=torch.float64),
                     -torch.arange(1.0, 6.0, dtype=torch.float64)])
    Y = dia_spmm_torch(data, X, (-7, 0, 2), 5)
    assert Y.tolist() == [[4, 6, 8, 4, 5], [-4, -6, -8, -4, -5]]


def test_spmm_wrapper_refuses_non_cpu_non_cuda_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        dia_spmm(torch.zeros((1, 128), device="meta"),
                 torch.zeros((2, 128), device="meta"), (0,), 128)


def stencil_offsets(nx, ny, use_7pt=False):
    """The DIA stencil's offsets, ascending (tests/test_torch_dia.py holds
    them to the JAX package's): sz nx ny + sy nx + sx."""
    A, _ = DiaMatrix.from_stencil(nx, ny, 3, use_7pt=use_7pt, device=CPU,
                                  policy=DTypePolicy.from_names("f32"))
    return A.offsets


@pytest.mark.parametrize("nx,ny,use_7pt,lens,shifts", [
    # every run of three centred on sz nx ny + sy nx = 0 mod 4
    (100, 100, False, [3] * 9, [0] * 9),
    (200, 200, False, [3] * 9, [0] * 9),
    # 7 points: -nx ny, -nx, the run -1 0 1, nx, nx ny; the singles read
    # X[i0 + o .. i0 + o + 3] with o their offset
    (100, 100, True, [1, 1, 3, 1, 1], [1, 1, 0, 1, 1]),
    (200, 200, True, [1, 1, 3, 1, 1], [1, 1, 0, 1, 1]),
    # nx = 10: the runs centred on sy = +-1 (+-10 = 2 mod 4) are scalar
    (10, 10, False, [3] * 9, [-1, 0, -1] * 3),
])
def test_spmm_plan_on_the_stencil(nx, ny, use_7pt, lens, shifts):
    """K8's gate on the stencil's offsets at n = nx ny nz, a multiple of 4,
    with 8 columns of f32 under bf16 diagonals: the staged form where the
    planes lie a tile or more apart (else four rows a thread), the runs as
    chunks in order, and which of them read x as one aligned vector a
    column (shift >= 0)."""
    offsets = stencil_offsets(nx, ny, use_7pt)
    n = nx * ny * 8
    plan = spmm_plan(offsets, n, n, n, n, True, 8, (2, 4))
    assert plan.form == ("quad" if nx == 10 else "staged")
    assert [c.length for c in plan.chunks] == lens
    assert [c.shift for c in plan.chunks] == shifts
    assert [c.d0 for c in plan.chunks] == list(np.cumsum([0] + lens[:-1]))
    assert [c.start for c in plan.chunks] == [offsets[c.d0]
                                              for c in plan.chunks]
    for c in plan.chunks:
        assert list(offsets[c.d0:c.d0 + c.length]) == list(
            range(c.start, c.start + c.length))


@pytest.mark.parametrize("n,nr_pad,ldx,ldy,aligned", [
    (630, 640, 630, 630, True),     # 10x9x7: n = 2 mod 4
    (800, 896, 801, 800, True),     # a row stride of X not a multiple of 4
    (800, 896, 800, 802, True),     # nor of Y
    (800, 898, 800, 800, True),     # nor of the diagonals
    (800, 896, 800, 800, False),    # a base pointer off 16 B
])
def test_spmm_plan_takes_the_general_form(n, nr_pad, ldx, ldy, aligned):
    """Where a size, a stride or a base pointer does not allow aligned
    vectors, one row a thread and every chunk read as scalars, whatever
    the columns and dtypes."""
    offsets = stencil_offsets(100, 100)
    for k, sizes in ((1, (2, 4)), (8, (2, 4)), (8, (8, 8))):
        plan = spmm_plan(offsets, n, nr_pad, ldx, ldy, aligned, k, sizes)
        assert plan.form == "row" and plan.windows == ()
        assert all(c.shift == -1 for c in plan.chunks)
        assert [c.length for c in plan.chunks] == [3] * 9
    # chunks of consecutive offsets stop at four diagonals
    plan = spmm_plan(range(-5, 5), 800, 896, 800, 800, True, 8, (2, 4))
    assert [(c.d0, c.length, c.start) for c in plan.chunks] == [
        (0, 4, -5), (4, 4, -1), (8, 2, 3)]


def test_aligned_shift_covers_what_four_rows_read():
    """For every chunk of 1-4 consecutive offsets: where aligned_shift
    gives a shift, the six x values from o - 1 (o = start + 1 - shift, 0
    mod 4) hold every value rows i0 .. i0 + 3 read, at index q + u + shift;
    where it gives -1, no o = 0 mod 4 does. A run of three is aligned
    exactly where its centre is 0 mod 4."""
    for start in range(-13, 14):
        for length in range(1, 5):
            shift = aligned_shift(start, length)
            fits = [o for o in range(start - 8, start + 9) if o % 4 == 0
                    and o - 1 <= start and start + length + 2 <= o + 4]
            assert (shift >= 0) == bool(fits), (start, length)
            if shift < 0:
                continue
            o = start + 1 - shift
            assert o % 4 == 0 and 0 <= shift <= 2
            for q in range(4):
                for u in range(length):
                    m = q + u + shift
                    assert 0 <= m <= 5 and o - 1 + m == q + start + u
            if length == 3:
                assert (shift == 0) == ((start + 1) % 4 == 0)
        assert aligned_shift(start, 3) in ((0,) if (start + 1) % 4 == 0
                                           else (-1,))


def emulate_four_row_form(data, X, offsets, n, plan):
    """csrc/dia_spmm.cu's four-row form in torch: a thread per four rows,
    x read as the kernel reads it (an aligned chunk's vector a column, the
    value before it from the previous lane's vector and the one after from
    the next lane's, lanes 0 and 31 reading theirs; another chunk's len + 3
    scalars), summed per row in the diagonals' order, one rounding an op."""
    assert plan.form in ("quad", "staged")
    k, xdt, zero = X.shape[0], X.dtype, torch.zeros((), dtype=X.dtype)
    threads = -(-(n // 4) // 128) * 128
    i0 = 4 * torch.arange(threads)
    lane = torch.arange(threads) % 32
    mine = i0 < n

    def at(j):
        """X[:, j] where 0 <= j < n, else 0: (k, threads)."""
        return torch.where((j >= 0) & (j < n), X[:, j.clamp(0, n - 1)], zero)

    acc = torch.zeros((k, threads, 4), dtype=xdt)
    rows = (i0[:, None] + torch.arange(4)).clamp(max=data.shape[1] - 1)
    for ch in plan.chunks:
        a = [torch.where(mine[:, None], data[ch.d0 + u][rows].to(xdt), zero)
             for u in range(ch.length)]
        if ch.shift >= 0:
            j0 = i0 + ch.start + 1 - ch.shift
            inside = (j0 >= 0) & (j0 < n)
            vec = torch.stack([torch.where(inside, at(j0 + m), zero)
                               for m in range(4)], -1)
            before = torch.where(lane == 0, at(j0 - 1),
                                 torch.roll(vec[..., 3], 1, dims=1))
            after = torch.where(lane == 31, at(j0 + 4),
                                torch.roll(vec[..., 0], -1, dims=1))
            w = torch.cat([before[..., None], vec, after[..., None]], -1)
            shift = ch.shift
        else:
            w = torch.stack([at(i0 + ch.start + m)
                             for m in range(ch.length + 3)], -1)
            shift = 0
        for u in range(ch.length):
            for q in range(4):
                acc[..., q] = acc[..., q] + a[u][:, q] * w[..., q + u + shift]
    return acc.reshape(k, -1)[:, :n]


@pytest.mark.parametrize("dims,use_7pt", [((10, 10, 8), False),
                                          ((12, 10, 9), False),
                                          ((8, 8, 8), True)])
@pytest.mark.parametrize("pair", PAIRS)
def test_four_row_form_emulated_equals_plain(dims, use_7pt, pair):
    """The four-row form's reads and sums, emulated on the CPU, give the
    plain version's bits: on the stencil with vector and scalar chunks
    (10x10x8), with vectors only (12x10x9) and with the 7-point singles,
    and on offsets of every phase mod 4 in chunks of 1-4."""
    A, _ = DiaMatrix.from_stencil(*dims, use_7pt=use_7pt, device=CPU,
                                  policy=DTypePolicy.from_names("f32"))
    rng = np.random.default_rng(sum(dims))
    cases = [(A.data, A.offsets, A.nr)]
    offsets = (-37, -36, -35, -10, -3, 0, 1, 2, 5, 6, 7, 8, 9, 41, 42)
    cases.append((torch.from_numpy(rng.standard_normal((len(offsets), 384))),
                  offsets, 256))
    for data, offs, n in cases:
        data = data.to(DT[pair[0]])
        X = torch.from_numpy(rng.standard_normal((3, n))).to(DT[pair[1]])
        plan = spmm_plan(offs, n, data.shape[1], n, n, True, 3,
                         (data.element_size(), X.element_size()))
        assert plan.form in ("quad", "staged")
        shifts = {c.shift for c in plan.chunks}
        assert shifts & {0, 1, 2} and (-1 in shifts or n == A.nr)
        got = emulate_four_row_form(data, X, offs, n, plan)
        want = dia_spmm_torch(data, X, offs, n)
        bits = torch.int64 if X.dtype == torch.float64 else torch.int32
        assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("nx,ny,nz,use_7pt,windows", [
    # (diagonals, least offset, largest) a window: one a plane of the stencil
    (100, 100, 100, False, [(9, -10101, -9899), (9, -101, 101),
                            (9, 9899, 10101)]),
    (200, 200, 200, False, [(9, -40201, -39799), (9, -201, 201),
                            (9, 39799, 40201)]),
    (100, 100, 100, True, [(1, -10000, -10000), (5, -100, 100),
                           (1, 10000, 10000)]),
    (200, 200, 200, True, [(1, -40000, -40000), (5, -200, 200),
                           (1, 40000, 40000)]),
    (30, 20, 12, False, [(9, -631, -569), (9, -31, 31), (9, 569, 631)]),
    # planes closer than a tile: one window
    (10, 10, 8, False, [(27, -111, 111)]),
    (12, 10, 9, False, [(27, -133, 133)]),
    (8, 8, 8, True, [(7, -64, 64)]),
])
def test_staged_windows_on_the_stencil(nx, ny, nz, use_7pt, windows):
    """The staged form's windows: runs of consecutive chunks whose offsets
    lie within a unit's rows of each other, in the diagonals' order; with
    more than one, the march through the planes of nx ny rows, and with
    one, planes too close to stage, the four-row form."""
    offsets = stencil_offsets(nx, ny, use_7pt)
    n = nx * ny * nz
    plan = spmm_plan(offsets, n, n, n, n, True, 8, (2, 4))
    wins = windows_of(plan.chunks)
    assert plan.form == ("staged" if len(windows) > 1 else "quad")
    assert plan.windows == (wins if len(windows) > 1 else ())
    assert march_plane(wins, n) == (nx * ny if len(windows) > 1 else 0)
    assert plan.plane == march_plane(wins, n)
    got = [(sum(c.length for c in plan.chunks[w.first:w.first + w.count]),
            w.lo, w.hi) for w in wins]
    assert got == windows
    assert [w.first for w in wins] == list(np.cumsum(
        [0] + [w.count for w in wins[:-1]]))
    assert sum(w.count for w in wins) == len(plan.chunks)
    for w in wins:
        chunks = plan.chunks[w.first:w.first + w.count]
        assert w.lo == min(c.start for c in chunks)
        assert w.hi == max(c.start + c.length - 1 for c in chunks)


# 200^3, 27 points: (k, data and X bytes a value) -> (rows, cols) or quad
STAGED_SHAPES = {
    (1, (2, 4)): (512, 1), (3, (2, 4)): (512, 3), (8, (2, 4)): (512, 8),
    (12, (2, 4)): (512, 8), (16, (2, 4)): (512, 8),
    (1, (4, 4)): (512, 1), (3, (4, 4)): (512, 3), (8, (4, 4)): (256, 8),
    (12, (4, 4)): (256, 8), (16, (4, 4)): (256, 8),
    (1, (8, 8)): (256, 1), (3, (8, 8)): (128, 3), (8, (8, 8)): None,
    (12, (8, 8)): None, (16, (8, 8)): None,
}


@pytest.mark.parametrize("k,sizes", list(STAGED_SHAPES))
def test_staged_shape_fills_the_shared_memory(k, sizes):
    """At 200^3: min(k, 8) columns a stage and the most rows, a multiple of
    128 up to 512, whose three data stages and five X slots fit 227 KB
    with the barriers and the guard; f64 with 8 or more columns does not
    fit at 128 rows and keeps the four-row form."""
    offsets = stencil_offsets(200, 200)
    n = 200 ** 3
    chunks = spmm_plan(offsets, n, n, n, n, True, k, sizes).chunks
    plan = staged_plan(chunks, n, n, k, sizes)
    want = STAGED_SHAPES[(k, sizes)]
    if want is None:
        assert plan is None
        assert spmm_plan(offsets, n, n, n, n, True, k, sizes).form == "quad"
        return
    assert plan.form == "staged" and (plan.rows, plan.cols) == want

    def used(rows):
        return STAGED.bar_bytes + STAGED.guard_bytes + ring_bytes(
            plan.windows, 27, rows, plan.cols, sizes, plan.plane)

    assert used(plan.rows) <= STAGED.smem_budget
    assert plan.rows == STAGED.tile_rows or used(plan.rows + 128) > (
        STAGED.smem_budget)
    if (k, sizes) == (8, (2, 4)):
        # three data stages of 27 x 512 bf16, five slots of 8 x 920 f32
        assert ring_bytes(plan.windows, 27, 512, 8, sizes, plan.plane) == (
            3 * 27648 + 5 * 29440)
        assert segments(plan.windows, plan.plane, 512, 4) == (
            (-40204, 920), (-204, 920), (39796, 920))


def four_row_case(case):
    """(offsets, n, nr_pad, k, sizes) of an input the four-row form keeps
    (test_spmm_plan_keeps_the_four_row_form)."""
    n, nr_pad, k, sizes = 65536, 65536, 8, (2, 4)
    if case == "17 windows":
        offsets = [1024 * i for i in range(-8, 9)]
    elif case == "over the budget":
        offsets = [4096 * w + 500 * j for w in (-1, 0, 1) for j in range(-3, 4)]
    elif case == "bf16 rows of 8 B multiples":
        offsets, nr_pad = stencil_offsets(64, 64), 65540
    elif case == "one window":
        offsets = stencil_offsets(10, 10)
    elif case == "planes not dividing n":
        offsets = stencil_offsets(40, 40)
        n = nr_pad = 40 * 40 * 40 + 4
    elif case == "f64 at 200^3":
        offsets, n, sizes = stencil_offsets(200, 200), 200 ** 3, (8, 8)
        nr_pad = n
    else:  # the data outweigh X: f32 diagonals under one column
        offsets, k, sizes = stencil_offsets(64, 64), 1, (4, 4)
    return offsets, n, nr_pad, k, sizes


FOUR_ROW_CASES = ["17 windows", "over the budget",
                  "bf16 rows of 8 B multiples", "f64 at 200^3", "one window",
                  "planes not dividing n", "the data outweigh X"]


@pytest.mark.parametrize("case", FOUR_ROW_CASES)
def test_spmm_plan_keeps_the_four_row_form(case):
    """Where the staged form does not apply, the four-row form runs as
    before: more windows than kMaxWindows (planes of 1024 rows), planes
    whose segments overflow the shared memory at 128 rows, bf16 diagonals
    whose rows are not 16 B multiples, f64 at 200^3 with 8 columns, one
    window (planes closer than a unit), n not a multiple of the planes,
    and a row's diagonals taking 7 or more times the bytes of its X values
    in a stage's columns (where staged_plan admits the staged form)."""
    offsets, n, nr_pad, k, sizes = four_row_case(case)
    plan = spmm_plan(offsets, n, nr_pad, n, n, True, k, sizes)
    assert plan.form == "quad" and plan.windows == ()
    assert all(c.shift == aligned_shift(c.start, c.length)
               for c in plan.chunks)
    staged = staged_plan(plan.chunks, n, nr_pad, k, sizes)
    assert (staged is not None) == (case == "the data outweigh X")


# (n, 7-point, data and X bytes a value, k) -> the form spmm_plan picks:
# the staged form where it was faster on the card (PERF.md §6)
STAGED_PICKS = {
    (200, False, (2, 4), 1): "quad", (200, False, (2, 4), 2): "staged",
    (200, False, (2, 4), 8): "staged", (200, False, (2, 4), 16): "staged",
    (200, False, (4, 4), 1): "quad", (200, False, (4, 4), 3): "quad",
    (200, False, (4, 4), 4): "staged", (200, False, (4, 4), 16): "staged",
    (200, False, (8, 8), 1): "quad", (200, False, (8, 8), 3): "quad",
    (200, True, (2, 4), 1): "staged", (200, True, (4, 4), 1): "quad",
    (200, True, (8, 8), 1): "quad", (200, True, (8, 8), 3): "staged",
    (100, False, (8, 8), 1): "quad", (100, False, (8, 8), 3): "quad",
    (100, False, (8, 8), 8): "staged", (100, False, (2, 4), 16): "staged",
}


@pytest.mark.parametrize("n,use_7pt,sizes,k", list(STAGED_PICKS))
def test_spmm_plan_stages_where_it_measured_faster(n, use_7pt, sizes, k):
    """On the stencils at 100^3 and 200^3, spmm_plan picks the staged form
    where the card ran it faster than the four-row form, and the four-row
    form where that was as fast or faster: f64 at 1 to 3 columns, f32
    diagonals under 1 column of f32 (the 27-point also at 3)."""
    offsets = stencil_offsets(n, n, use_7pt)
    rows = n ** 3
    plan = spmm_plan(offsets, rows, rows, rows, rows, True, k, sizes)
    assert plan.form == STAGED_PICKS[(n, use_7pt, sizes, k)]
    assert staged_plan(plan.chunks, rows, rows, k, sizes) is not None


def test_staged_constants_match_the_source():
    """ops/dia_spmm.py STAGED holds csrc/dia_spmm.cu's constants."""
    import re

    src = (_build.CSRC_DIR / "dia_spmm.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert STAGED == STAGED._make([const(n) for n in (
        "kTileRows", "kTileStep", "kMarchStages", "kStageCols",
        "kSmemBudget", "kMaxWindows")] + [
            (2 * const("kMarchStages") * 8 + 15) // 16 * 16,
            const("kGuardBytes")])
    assert ("constexpr int kBarBytes = (2 * kMarchStages * 8 + 15) / 16 * 16;"
            in src)
    assert const("kRunPlanes") == RUN_PLANES


@pytest.mark.parametrize("windows,n,plane", [
    ([(-40201, -39799), (-201, 201), (39799, 40201)], 200 ** 3, 40000),
    ([(-40000, -40000), (-200, 200), (40000, 40000)], 200 ** 3, 40000),
    ([(-40201, -39799), (-201, 201), (39799, 40201)], 200 ** 3 + 8, 0),
    ([(-1500, -1499), (-700, 9), (700, 700), (1501, 1501)], 2044, 0),
    ([(-1004, -1004), (0, 0), (1004, 1004)], 2008, 0),   # P not 0 mod 8
    ([(0, 0), (1000, 1000), (2000, 2000)], 4000, 1000),
    ([(0, 0), (1000, 1000), (2008, 2008)], 4000, 0),     # not even
    ([(-64, 64)], 512, 0),
])
def test_march_plane(windows, n, plane):
    """The staged form marches where two or more windows' centres lie P > 0
    apart, P = 0 mod 8 and n = 0 mod P."""
    assert march_plane([Window(i, 1, lo, hi)
                        for i, (lo, hi) in enumerate(windows)], n) == plane


RUN_PLANES = 32  # csrc/dia_spmm.cu kRunPlanes


def staged_runs(plan, n, k, resident):
    """The staged form's runs for a grid of at most ``resident`` blocks
    (csrc/dia_spmm.cu run_at and march_runs), each a list of its units
    (i0, rows, c0), and the grid. A run is a strip's units of up to
    RUN_PLANES planes in a row, the most whose busiest block has the fewest
    units, runs going group by group, plane segment by segment, strip by
    strip."""
    rows, cols, plane = plan.rows, plan.cols, plan.plane
    groups = -(-k // cols)
    strips, planes = -(-plane // rows), n // plane
    best = None
    for zs in range(RUN_PLANES, 0, -1):
        count = groups * -(-planes // zs) * strips
        busiest = -(-count // min(count, resident)) * zs
        if best is None or busiest < best[0]:
            best = (busiest, zs)
    zs = best[1]
    runs = [[((z0 + z) * plane + s * rows, min(rows, plane - s * rows),
              grp * cols) for z in range(min(zs, planes - z0))]
            for grp in range(groups) for z0 in range(0, planes, zs)
            for s in range(strips)]
    return runs, min(len(runs), resident)


def ring_schedule(plan, runs, blocks, x_size, stages):
    """Each block's walk of its runs (run b, b + blocks, ...) through the
    X slot ring (csrc/dia_spmm.cu staged_produce and staged_consume), with
    ``stages`` units in flight and windows + stages - 1 slots. Unit j reads
    window w from slot (f_j + w) mod R, f growing by 1 within a run and by
    the window count where a run starts; the producer loads unit j's new
    segments once unit j - stages is released (at a run's start, unit j -
    1), while the units after it may still be summed. Returns the segments
    loaded and the busiest block's units; raises where a load overwrites a
    slot a running unit reads, or a unit reads a slot that holds another
    segment than its window's."""
    nw = len(plan.windows)
    slots = nw + stages - 1
    segs = segments(plan.windows, plan.plane, plan.rows, x_size)
    loads = busiest = 0
    for b in range(blocks):
        units = [(i0, c0, z > 0) for run in runs[b::blocks]
                 for z, (i0, _rows, c0) in enumerate(run)]
        busiest = max(busiest, len(units))
        held, fs, released = {}, [], -1
        for j, (i0, c0, cont) in enumerate(units):
            fs.append(0 if j == 0 else fs[-1] + (1 if cont else nw))
            f = fs[-1]
            released = max(released, j - stages if cont else j - 1)
            running = {(fs[jj] + w) % slots
                       for jj in range(released + 1, j) for w in range(nw)}
            for w in range(nw - 1 if cont else 0, nw):
                assert (f + w) % slots not in running, (b, j, w)
                held[(f + w) % slots] = (c0, i0 + segs[w][0], segs[w][1])
                loads += 1
            for w in range(nw):
                assert held[(f + w) % slots] == (c0, i0 + segs[w][0],
                                                 segs[w][1]), (b, j, w)
    return loads, busiest


@pytest.mark.parametrize("dims,k", [((200, 200, 200), 8), ((100, 100, 100), 8),
                                    ((30, 20, 12), 12), ((30, 20, 12), 3),
                                    ((30, 24, 6), 16)])
@pytest.mark.parametrize("blocks", [132, 7, 1])
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_staged_ring_schedule(dims, k, blocks, stages):
    """The runs cover every unit once, and the slot ring on the stencil
    gives every unit its windows' segments and overwrites no slot in use,
    for 132, 7 and 1 blocks and two to four stages (the kernel's: three).
    The march loads one segment a unit and column group but at a run's
    start, and its busiest block has as few units as any split of them
    (200^3, 132 blocks: runs of 20 planes, 1.1 loads a unit against 3
    without the march, 120 units)."""
    offsets = stencil_offsets(dims[0], dims[1])
    n = dims[0] * dims[1] * dims[2]
    plan = spmm_plan(offsets, n, n, n, n, True, k, (2, 4))
    assert plan.form == "staged"
    runs, grid = staged_runs(plan, n, k, blocks)
    units = [u for run in runs for u in run]
    tiles = [z * plan.plane + s for z in range(n // plan.plane)
             for s in range(0, plan.plane, plan.rows)]
    assert sorted((i0, c0) for i0, _, c0 in units) == sorted(
        (i0, c0) for c0 in range(0, k, plan.cols) for i0 in tiles)
    loads, busiest = ring_schedule(plan, runs, grid, 4, stages)
    assert loads >= len(plan.windows) * len(runs)
    if dims == (200, 200, 200) and blocks == 132:
        assert len(runs[0]) == 20 and loads == 1.1 * len(units)
        assert busiest == -(-len(units) // 132) == 120


def emulate_staged_form(data, X, n, plan):
    """csrc/dia_spmm.cu's staged form in torch, unit by unit
    (``staged_runs``): the data stage as the producer fills it (rows past
    the unit's copy left as NaN), each window's segment (``segments``:
    zeros outside [0, n), NaN in the two values on either side that the
    edge lanes may read), and the consumers' reads from them (an aligned
    chunk's vector a column, the values around it by shuffle within a warp
    of 32 quads, lanes 0 and 31 reading theirs; another chunk's len + 3
    scalars), summed per row window by window in the diagonals' order, one
    rounding an op; each unit stores its rows."""
    assert plan.form == "staged"
    rows = plan.rows
    k, xdt, nan = X.shape[0], X.dtype, float("nan")
    zero = torch.zeros((), dtype=xdt)
    r0 = 4 * torch.arange(rows // 4)
    lane = torch.arange(rows // 4) % 32
    segs = segments(plan.windows, plan.plane, rows, X.element_size())
    Y = torch.full((k, n), nan, dtype=xdt)
    for i0, unit_rows, c0 in (u for run in staged_runs(plan, n, k, 132)[0]
                              for u in run):
        ds = torch.full((data.shape[0], rows), nan, dtype=xdt)
        ds[:, :unit_rows] = data[:, i0:i0 + unit_rows].to(xdt)
        kc = min(plan.cols, k - c0)
        acc = torch.zeros((kc, rows // 4, 4), dtype=xdt)
        for win, (lo, length) in zip(plan.windows, segs):
            j = i0 + lo + torch.arange(length)
            seg = torch.where((j >= 0) & (j < n),
                              X[c0:c0 + kc, j.clamp(0, n - 1)], zero)
            seg = torch.cat([torch.full((kc, 2), nan, dtype=xdt), seg,
                             torch.full((kc, 2), nan, dtype=xdt)], 1)
            for ch in plan.chunks[win.first:win.first + win.count]:
                a = [ds[ch.d0 + u][r0[:, None] + torch.arange(4)]
                     for u in range(ch.length)]
                p0 = ch.start - lo + 2  # + 2: the NaN before the segment
                if ch.shift >= 0:
                    p = r0 + p0 + 1 - ch.shift
                    vec = torch.stack([seg[:, p + q] for q in range(4)], -1)
                    warps = vec.reshape(kc, -1, 32, 4)
                    before = torch.roll(warps[..., 3], 1, 2).reshape(kc, -1)
                    after = torch.roll(warps[..., 0], -1, 2).reshape(kc, -1)
                    before = torch.where(lane == 0, seg[:, p - 1], before)
                    after = torch.where(lane == 31, seg[:, p + 4], after)
                    w = torch.cat([before[..., None], vec, after[..., None]],
                                  -1)
                    shift = ch.shift
                else:
                    w = torch.stack([seg[:, r0 + p0 + m]
                                     for m in range(ch.length + 3)], -1)
                    shift = 0
                for u in range(ch.length):
                    for q in range(4):
                        acc[..., q] = (acc[..., q]
                                       + a[u][:, q] * w[..., q + u + shift])
        Y[c0:c0 + kc, i0:i0 + unit_rows] = acc.reshape(kc, rows)[:, :unit_rows]
    return Y


@pytest.mark.parametrize("case,k", [
    ("30x24x6", 16),    # vector and scalar chunks; two groups of 8 columns
    ("40x16x5", 12),    # every chunk a vector; groups of 8 and 4 columns
    ("40x16x5 7-point", 3),
    ("30x20x12", 9),    # three windows, strips of 512 and 88
    ("30x20x12 7-point", 8),  # windows of 1, 5 and 1 diagonals
    ("synthetic", 3),   # four planes, every phase mod 4, chunks of 1-4
])
@pytest.mark.parametrize("pair", PAIRS)
def test_staged_form_emulated_equals_plain(case, k, pair):
    """The staged form's stages, reads and sums, emulated on the CPU, give
    the plain version's bits: the windows' zeros at the ends of X, the
    strips (the last one of a plane partial), column groups and the sum
    order across windows, wherever staged_plan admits it."""
    rng = np.random.default_rng(len(case) + k)
    if case == "synthetic":
        offsets = (-2037, -2036, -2001, -2000, -1963,
                   -1037, -1036, -1035, -1003, -1000, -999, -963,
                   -37, -3, 0, 1, 2, 5, 6, 7, 8, 9, 37,
                   963, 1000, 1001, 1037)
        n = 4000
        data = torch.from_numpy(rng.standard_normal((len(offsets), 4096)))
    else:
        dims = tuple(int(v) for v in case.split()[0].split("x"))
        A, _ = DiaMatrix.from_stencil(*dims, use_7pt="7-point" in case,
                                      device=CPU,
                                      policy=DTypePolicy.from_names("f32"))
        offsets, n, data = A.offsets, A.nr, A.data
    data = data.to(DT[pair[0]])
    X = torch.from_numpy(rng.standard_normal((k, n))).to(DT[pair[1]])
    sizes = (data.element_size(), X.element_size())
    plan = staged_plan(spmm_plan(offsets, n, data.shape[1], n, n, True, k,
                                 sizes).chunks, n, data.shape[1], k, sizes)
    assert plan.form == "staged" and len(plan.windows) == (
        4 if case == "synthetic" else 3)
    assert plan.plane == (1000 if case == "synthetic" else
                          int(np.prod([int(v) for v in
                                       case.split()[0].split("x")[:2]])))
    got = emulate_staged_form(data, X, n, plan)
    want = dia_spmm_torch(data, X, offsets, n)
    bits = torch.int64 if X.dtype == torch.float64 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


def test_k8_variants_are_one_edit_of_the_source(tmp_path):
    """profile_cg --k8-variants writes each variant as this tree's
    csrc/dia_spmm.cu with its edits, each found once, beside the shared
    headers."""
    from sparsebench_tpu_torch.profile_cg import K8_VARIANTS, variant_trees

    src = (_build.CSRC_DIR / "dia_spmm.cu").read_text()
    trees = variant_trees(tmp_path, "dia_spmm.cu", K8_VARIANTS)
    assert [name for name, _, _ in trees] == [v[0] for v in K8_VARIANTS]
    for (name, tree, right), (_, edits, _) in zip(trees, K8_VARIANTS):
        csrc = tree / "sparsebench_tpu_torch" / "csrc"
        text = (csrc / "dia_spmm.cu").read_text()
        assert text != src and all(new in text for _, new in edits), name
        assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(
            p.name for p in _build.CSRC_DIR.glob("*.cuh"))
    assert [right for _, _, right in trees].count(False) == 2


def test_stencil_variants_are_one_edit_of_the_source(tmp_path):
    """profile_cg --stencil-variants writes each variant as this tree's
    csrc/stencil.cu with its edits (the kernels' launch bounds), each
    found once, beside the shared headers."""
    from sparsebench_tpu_torch.profile_cg import STENCIL_VARIANTS, variant_trees

    src = (_build.CSRC_DIR / "stencil.cu").read_text()
    trees = variant_trees(tmp_path, "stencil.cu", STENCIL_VARIANTS)
    assert [name for name, _, _ in trees] == [v[0] for v in STENCIL_VARIANTS]
    for (name, tree, right), (_, edits, _) in zip(trees, STENCIL_VARIANTS):
        csrc = tree / "sparsebench_tpu_torch" / "csrc"
        text = (csrc / "stencil.cu").read_text()
        assert edits and right, name
        assert text != src and all(new in text for _, new in edits), name
        assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(
            p.name for p in _build.CSRC_DIR.glob("*.cuh"))


def test_vmem_variants_are_one_edit_of_the_source(tmp_path):
    """profile_cg --vmem-variants writes each variant, and each build of
    one phase alone, as this tree's csrc/stencil_cg_vmem.cu with its edit,
    found once, beside the shared headers; the forced plans it times are
    plans cg_plan accepts."""
    from sparsebench_tpu_torch.ops.stencil_cg_vmem import cg_plan
    from sparsebench_tpu_torch.profile_cg import (
        VMEM_PHASES,
        VMEM_PLANS,
        VMEM_VARIANTS,
        variant_trees,
    )

    src = (_build.CSRC_DIR / "stencil_cg_vmem.cu").read_text()
    variants = (*VMEM_VARIANTS,
                *((name, edits, None) for name, edits in VMEM_PHASES))
    trees = variant_trees(tmp_path, "stencil_cg_vmem.cu", variants)
    assert [name for name, _, _ in trees] == [v[0] for v in variants]
    for (name, tree, _), (_, edits, _) in zip(trees, variants):
        csrc = tree / "sparsebench_tpu_torch" / "csrc"
        text = (csrc / "stencil_cg_vmem.cu").read_text()
        assert len(edits) == 1 and text != src, name
        assert all(new in text for _, new in edits), name
        assert sorted(p.name for p in csrc.glob("*.cuh")) == sorted(
            p.name for p in _build.CSRC_DIR.glob("*.cuh"))
    for force in VMEM_PLANS:
        for n in (100, 200):
            plan = cg_plan(n, n, n, 4, 396, **force)
            assert all(getattr(plan, k) == v for k, v in force.items())


def assert_spmm_is_k1_column_by_column(data, X, offsets, nr):
    """K8 once on the card, bit for bit the plain version and, column by
    column, K1; returns the form it ran (``spmm_plan``, as the wrapper
    reads it)."""
    before = dia_spmm.launches
    Y = dia_spmm(data, X, offsets, nr)
    assert dia_spmm.launches == before + 1
    assert_bits_equal(Y, dia_spmm_torch(data, X, offsets, nr))
    for c in range(X.shape[0]):
        assert_bits_equal(Y[c], dia_spmv(data, X[c].contiguous(), offsets, nr))
    aligned = all(t.data_ptr() % 16 == 0 for t in (data, X))
    return spmm_plan(offsets, nr, data.shape[1], X.shape[1], nr, aligned,
                     X.shape[0], (data.element_size(), X.element_size())).form


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("k", [1, 2, 8, 9, 16])
def test_spmm_kernel_equals_plain_and_k1(pair, k, cuda_device):
    A, _ = DiaMatrix.from_stencil(10, 9, 7, policy=DTypePolicy.from_names("f32"),
                                  device=cuda_device)
    X = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (k, A.nr))).to(device=cuda_device, dtype=DT[pair[1]])
    assert_spmm_is_k1_column_by_column(A.data.to(DT[pair[0]]), X, A.offsets,
                                       A.nr)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("offsets,nr,form", [
    ((-1000, -1, 0, 1, 999), 8192, "quad"),
    ((0,), 1, "row"), ((-3, 5), 7, "row"),
    # planes of 1000 rows: strips of 512 and 488; planes of 4096: a
    # window wholly outside [0, n) in each, read as zeros
    ((-1000, -1, 0, 1, 1000), 8000, "staged"),
    ((-4096, -1, 0, 1, 4096), 8192, "staged"),
])
def test_spmm_kernel_on_edge_offsets(pair, offsets, nr, form, cuda_device):
    rng = np.random.default_rng(nr)
    nr_pad = -(-nr // 128) * 128  # the diagonals' rows as a DiaMatrix pads them
    data = torch.from_numpy(rng.standard_normal((len(offsets), nr_pad)))
    X = torch.from_numpy(rng.standard_normal((3, nr)))
    assert assert_spmm_is_k1_column_by_column(
        data.to(device=cuda_device, dtype=DT[pair[0]]),
        X.to(device=cuda_device, dtype=DT[pair[1]]), offsets, nr) == form


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("dims", [(10, 10, 8), (12, 10, 9)])
@pytest.mark.parametrize("layout", ["contiguous", "ldx", "offset"])
def test_spmm_kernel_forms_equal_plain_and_k1(layout, dims, pair,
                                              cuda_device):
    """K8's gate on the card: four rows a thread (one window, too close to
    stage) with vector and scalar chunks (10x10x8) or vectors only
    (12x10x9), and one row a thread for an X with a row stride of nr + 1
    or 4 B past 16 B."""
    A, _ = DiaMatrix.from_stencil(*dims, policy=DTypePolicy.from_names("f32"),
                                  device=cuda_device)
    rng = np.random.default_rng(A.nr)
    cols = A.nr + (layout == "ldx")
    flat = torch.from_numpy(rng.standard_normal(8 * cols + 1)).to(
        device=cuda_device, dtype=DT[pair[1]])
    X = (flat[1:] if layout == "offset" else flat[:-1]).view(8, cols)
    form = assert_spmm_is_k1_column_by_column(A.data.to(DT[pair[0]]), X,
                                              A.offsets, A.nr)
    assert form == ("quad" if layout == "contiguous" else "row")


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("k", [1, 3, 8, 12, 16])
def test_staged_kernel_equals_plain_and_k1(k, pair, cuda_device):
    """The staged form at 30x20x12 (three windows, planes at both ends of X
    with a window outside it, strips of 512 and 88 rows, one or two column
    groups), run where staged_plan admits it whatever spmm_plan picks: bit
    for bit the plain version and, column by column, K1; and the wrapper
    runs the form spmm_plan picks."""
    from sparsebench_tpu_torch.profile_cg import k8_as

    A, _ = DiaMatrix.from_stencil(30, 20, 12, policy=DTypePolicy.from_names(
        "f32"), device=cuda_device)
    data = A.data.to(DT[pair[0]])
    X = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (k, A.nr))).to(device=cuda_device, dtype=DT[pair[1]])
    sizes = (data.element_size(), X.element_size())
    picked = spmm_plan(A.offsets, A.nr, data.shape[1], A.nr, A.nr, True, k,
                       sizes)
    plan = staged_plan(picked.chunks, A.nr, data.shape[1], k, sizes)
    Y = k8_as(plan, data, X, A.nr)
    assert_bits_equal(Y, dia_spmm_torch(data, X, A.offsets, A.nr))
    for c in range(k):
        assert_bits_equal(Y[c], dia_spmv(data, X[c].contiguous(), A.offsets,
                                         A.nr))
    assert assert_spmm_is_k1_column_by_column(
        data, X, A.offsets, A.nr) == picked.form


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("case", [c for c in FOUR_ROW_CASES
                                  if c != "f64 at 200^3"])
def test_spmm_kernel_keeps_the_four_row_form(case, pair, cuda_device):
    """Where the plan does not stage, the four-row form runs as before, bit
    for bit the plain version and K1 (test_spmm_plan_keeps_the_four_row_form
    holds the plan)."""
    rng = np.random.default_rng(len(case))
    offsets, n, nr_pad, k, _sizes = four_row_case(case)
    data = torch.from_numpy(rng.standard_normal((len(offsets), nr_pad))).to(
        device=cuda_device, dtype=DT[pair[0]])
    X = torch.from_numpy(rng.standard_normal((k, n))).to(
        device=cuda_device, dtype=DT[pair[1]])
    form = assert_spmm_is_k1_column_by_column(data, X, offsets, n)
    assert form == ("staged" if case == "bf16 rows of 8 B multiples"
                    and pair[0] != "bf16" else "quad")


@pytest.mark.cuda
def test_staged_launches_count_in_the_recorder(cuda_device):
    """While the recorder records, each launch of the staged form counts
    ``dia_spmm.staged`` and the ``dia.spmm`` span's form reads ``staged``;
    a launch of another form counts nothing."""
    from sparsebench_tpu_torch import profiler

    A, _ = DiaMatrix.from_stencil(30, 20, 12, policy=DTypePolicy.from_names(
        "f32"), device=cuda_device, impl="kernel")
    X = torch.rand((8, A.nr), device=cuda_device)
    profiler.RECORDER.clear()
    profiler.set_mode("on")
    try:
        for _ in range(4):
            A.spmm_kn(X)
        # X 4 B past 16 B: one row a thread
        A.spmm_kn(torch.rand(8 * A.nr + 1, device=cuda_device)[1:]
                  .view(8, A.nr))
        forms = [s.attrs["form"] for s in profiler.spans()
                 if s.name == "dia.spmm"]
        assert forms == ["staged"] * 4 + ["row"]
        assert profiler.counts()["dia_spmm.staged"] == 4
    finally:
        profiler.set_mode("auto")
        profiler.RECORDER.clear()


@pytest.mark.cuda
def test_spmm_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    data = torch.zeros((2, 256), device=cuda_device)
    X = torch.zeros((3, 256), device=cuda_device)
    with pytest.raises(TypeError, match="no kernel"):
        dia_spmm(data, X.double(), (0, 1), 256)
    with pytest.raises(ValueError, match="ndiag"):
        dia_spmm(data, X, (0,), 256)
    with pytest.raises(ValueError, match="nr"):
        dia_spmm(data, X[:, :100], (0, 1), 200)
    with pytest.raises(ValueError, match="contiguous"):
        dia_spmm(data, X[:, ::2], (0, 1), 128)
    with pytest.raises(ValueError, match="both"):
        dia_spmm(data, X.cpu(), (0, 1), 256)


@pytest.mark.cuda
def test_cg_multi_through_the_kernel_equals_plain(cuda_device):
    """f64 blocked CG at 12^3 with 3 seeded right-hand sides: K8 and the
    plain version give the same counts, history and X, bit for bit."""
    from sparsebench_tpu_torch.solvers.cg_multi import solve_cg_multi

    f64 = DTypePolicy.from_names("f64")
    results = []
    for impl in ("kernel", "torch"):
        A, _ = DiaMatrix.from_stencil(12, 12, 12, device=cuda_device,
                                      policy=f64, impl=impl)
        B = np.random.default_rng(4).standard_normal((A.nr, 3))
        before = dia_spmm.launches
        results.append(solve_cg_multi(A, B, itermax=40, verbose=False))
        assert (dia_spmm.launches - before == 2 * 40) == (impl == "kernel")
    rk, rt = results
    assert rk.iterations == rt.iterations == 40
    np.testing.assert_array_equal(rk.residual_history, rt.residual_history)
    np.testing.assert_array_equal(rk.x, rt.x)


@pytest.mark.cuda
def test_cli_nrhs_runs_the_kernel(cuda_device, capsys):
    before = dia_spmm.launches
    assert cli.main(["-t", "cg", "--nrhs", "4", "-x", "16", "-y", "16", "-z",
                     "16", "-i", "30"]) == 0
    out = capsys.readouterr().out
    assert dia_spmm.launches - before == 2 * 30
    assert "Blocked CG: 4 right-hand sides" in out
    assert "Difference between" in out


# -- K12: the read ceiling -----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles,reps,tile_rows",
                         [(1, 1, 8), (3, 2, 16), (7, 9, 2048)])
def test_read_passes_kernel_matches_plain(n_tiles, reps, tile_rows,
                                          cuda_device):
    """K12's out and sink equal the plain version's bit for bit, on ones
    (out exactly reps * n_tiles) and on seeded random data; 63 steps take
    the unrolled loop's remainder."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    shape = (n_tiles * tile_rows, 128)
    for fill in ("ones", "randn"):
        x = (torch.ones(shape, device=cuda_device) if fill == "ones"
             else torch.randn(shape, generator=gen, device=cuda_device))
        before = read_passes.launches
        out, sink = read_passes(x, n_tiles, reps, tile_rows)
        assert read_passes.launches == before + 1
        out_p, sink_p = read_passes_torch(x, n_tiles, reps, tile_rows)
        assert torch.equal(out, out_p) and torch.equal(sink, sink_p)
        if fill == "ones":
            assert bool((out == reps * n_tiles).all())


@pytest.mark.cuda
def test_read_passes_refusals_on_the_card(cuda_device):
    x = torch.ones((32, 256), device=cuda_device)[:, :128]
    with pytest.raises(ValueError, match="contiguous"):
        read_passes(x, 2, 1, 16)
    with pytest.raises(ValueError, match="L2"):
        measure_dma_read_gbps(n_floats=1 << 20)


@pytest.mark.cuda
def test_read_ceiling_launches_the_kernel(cuda_device):
    """Two warm-ups, then three trials at reps and three at 3 reps."""
    before = read_passes.launches
    gbps = measure_dma_read_gbps()
    assert read_passes.launches - before == 8
    assert math.isfinite(gbps) and gbps > 0


# -- K9, K10 and K11: the bsell SpMV ------------------------------------------


def bsell_case(name, device):
    """A BsellMatrix (f32 policy: bf16 values where lossless): the stencil
    through the host CSR and on the device (several tiles, windows past
    chunk 0), klein, a test matrix and a random banded matrix."""
    f32 = DTypePolicy.from_names("f32")
    if name == "stencil_device":
        return BsellMatrix.from_stencil(20, 20, 12, device=device,
                                        policy=f32)[0]
    if name == "stencil_csr":
        csr = generate_stencil(20, 20, 12)
    elif name == "klein":
        csr = read_mm(str(DATA / "matrix_band_klein.mtx"))
    elif name == "test9":
        csr = read_mm(str(DATA / "testMatrices" / "test9.mtx"))
    else:
        csr = random_csr(5000, 5000, 0.002, 7)
    return BsellMatrix.from_csr(csr, f32, device=device)


BSELL_CASES = ["stencil_device", "stencil_csr", "klein", "test9", "random"]


def test_bsell_window_fit():
    """K10 and K11 hold two W-row chunks of x: one block at the CLI's 100^3
    build in f32 (W 168), else the smallest cluster whose blocks hold a
    stripe each and the row buffers (100^3 f64: 2; 200^3 on the device, W
    640: 4, f64 7); the refusal, above a cluster of 8, names the size."""
    plan = bsell_ops.win_plan(168, torch.float32)
    assert (plan.cluster, plan.smem) == (1, 128 + 172_032)
    assert bsell_ops.win_plan(168, torch.float64).cluster == 2
    assert bsell_ops.win_plan(640, torch.float32).cluster == 4
    assert bsell_ops.win_plan(640, torch.float64).cluster == 7
    with pytest.raises(ValueError, match=r"\d+ B of shared memory a block in "
                       "a cluster of 8"):
        bsell_ops.win_plan(4000, torch.float32)
    with pytest.raises(ValueError, match="cluster size"):
        bsell_ops.win_plan(168, torch.float32, cluster=9)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("case", BSELL_CASES)
def test_bsell_kernels_equal_plain(case, pair, cuda_device):
    """K9, K10 and K11 against the plain version, bit for bit."""
    A = bsell_case(case, cuda_device)
    vals = A.vals.to(DT[pair[0]])
    x = torch.from_numpy(np.random.default_rng(A.nr).standard_normal(
        A.nc)).to(cuda_device, DT[pair[1]])
    x2d = A.padded_x(x, A.nc_pad // 128)
    y_ref = bsell_ops.bsell_spmv_torch(A.blocks, A.win_base, x2d, vals,
                                       A.lidx)
    before = bsell_ops.bsell_spmv.launches
    y = bsell_ops.bsell_spmv(A.blocks, A.win_base, x2d, vals, A.lidx)
    assert bsell_ops.bsell_spmv.launches == before + 1
    assert bool(torch.isfinite(y).all())
    assert_bits_equal(y, y_ref)
    xw = A.padded_x(x, A.xw_rows)
    for fn in (bsell_ops.bsell_spmv_win2, bsell_ops.bsell_spmv_windowed):
        before = fn.launches
        y = fn(A.wchunk, A.blocks, xw, vals, A.lidx, w_blocks=A.w_blocks)
        assert fn.launches == before + 1
        assert_bits_equal(y, y_ref)


@pytest.mark.cuda
def test_bsell_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    A = bsell_case("stencil_csr", cuda_device)
    x2d = A.padded_x(torch.ones(A.nc, device=cuda_device), A.nc_pad // 128)
    with pytest.raises(TypeError, match="no kernel"):
        bsell_ops.bsell_spmv(A.blocks, A.win_base, x2d.double(), A.vals,
                             A.lidx)
    with pytest.raises(ValueError, match="CUDA device"):
        bsell_ops.bsell_spmv(A.blocks, A.win_base, x2d.cpu(), A.vals, A.lidx)
    with pytest.raises(ValueError, match="lidx"):
        bsell_ops.bsell_spmv(A.blocks, A.win_base, x2d, A.vals,
                             A.lidx.to(torch.int32))
    for fn in (bsell_ops.bsell_spmv_win2, bsell_ops.bsell_spmv_windowed):
        before = fn.launches
        # two chunks of 4000 rows: 4,096,000 B, over what 8 blocks hold
        with pytest.raises(ValueError, match="shared memory a block in a "
                           "cluster of 8"):
            fn(A.wchunk, A.blocks, x2d, A.vals, A.lidx, w_blocks=4000)
        with pytest.raises(ValueError, match="cluster size"):
            fn(A.wchunk, A.blocks, x2d, A.vals, A.lidx, w_blocks=A.w_blocks,
               cluster=9)
        assert fn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
@pytest.mark.parametrize("case", ["stencil_device", "klein", "random"])
def test_bsell_win_forced_cluster_equals_plain(case, pair, cuda_device):
    """K10 and K11 in a forced cluster of 2 where one block would do: each
    block holds half of every chunk and reads the other half's rows from x
    through L2, both through the warps' row buffers; bit for bit."""
    A = bsell_case(case, cuda_device)
    vals = A.vals.to(DT[pair[0]])
    x = torch.from_numpy(np.random.default_rng(A.nr).standard_normal(
        A.nc)).to(cuda_device, DT[pair[1]])
    assert bsell_ops.win_plan(A.w_blocks, x.dtype).cluster == 1
    y_ref = bsell_ops.bsell_spmv_torch(A.blocks, A.win_base,
                                       A.padded_x(x, A.nc_pad // 128), vals,
                                       A.lidx)
    xw = A.padded_x(x, A.xw_rows)
    for fn in (bsell_ops.bsell_spmv_win2, bsell_ops.bsell_spmv_windowed):
        assert_bits_equal(fn(A.wchunk, A.blocks, xw, vals, A.lidx,
                             w_blocks=A.w_blocks, cluster=2), y_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", PAIRS)
def test_bsell_windowed_kernels_at_200_cubed(pair, cuda_device):
    """The 200^3 stencil on the device (W 640): K10 and K11 spread the
    window over a cluster of 4 blocks (f64: 7), bit for bit against the
    plain version."""
    A = BsellMatrix.from_stencil(200, 200, 200, device=cuda_device,
                                 policy=DTypePolicy.from_names("f32"))[0]
    vals = A.vals.to(DT[pair[0]])
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        A.nc)).to(cuda_device, DT[pair[1]])
    plan = bsell_ops.win_plan(A.w_blocks, x.dtype)
    assert (A.w_blocks, plan.cluster) == (640, 4 if pair[1] == "f32" else 7)
    y_ref = bsell_ops.bsell_spmv_torch(A.blocks, A.win_base,
                                       A.padded_x(x, A.nc_pad // 128), vals,
                                       A.lidx)
    xw = A.padded_x(x, A.xw_rows)
    for fn in (bsell_ops.bsell_spmv_win2, bsell_ops.bsell_spmv_windowed):
        assert_bits_equal(fn(A.wchunk, A.blocks, xw, vals, A.lidx,
                             w_blocks=A.w_blocks), y_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,kernel", [
    ("auto", "kernel"), ("kernel", "kernel"), ("kernel_win2", "kernel_win2"),
    ("kernel_win", "kernel_win")])
def test_bsell_cg_through_the_kernels_equals_plain(impl, kernel, cuda_device):
    """f64 CG on the 20x20x12 stencil through the host CSR: each kernel and
    the plain version give the same k and history, bit for bit."""
    f64 = DTypePolicy.from_names("f64")
    csr = generate_stencil(20, 20, 12)
    b = 27.0 - (csr.row_lengths - 1.0)
    results = []
    for which in (impl, "torch"):
        A = BsellMatrix.from_csr(csr, f64, device=cuda_device, impl=which)
        assert A.impl == (kernel if which == impl else "torch")
        results.append(cg.solve_cg(A, b, itermax=60, verbose=False))
    rk, rt = results
    assert rk.iterations == rt.iterations
    np.testing.assert_array_equal(rk.residual_history, rt.residual_history)
    np.testing.assert_array_equal(rk.x, rt.x)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,kernel", [
    ("auto", "bsell_spmv"), ("kernel_win2", "bsell_spmv_win2"),
    ("kernel_win", "bsell_spmv_windowed")])
def test_cli_bsell_default_device_runs_the_kernels(impl, kernel, cuda_device,
                                                   capsys):
    fns = {name: getattr(bsell_ops, name) for name in (
        "bsell_spmv", "bsell_spmv_win2", "bsell_spmv_windowed")}
    before = {name: fn.launches for name, fn in fns.items()}
    assert cli.main(["-t", "cg", "-i", "30", "--fmt", "bsell", "-x", "16",
                     "-y", "16", "-z", "16", "--impl", impl]) == 0
    out = capsys.readouterr().out
    for name, fn in fns.items():
        assert (fn.launches > before[name]) == (name == kernel), name
    assert "Difference between" in out


@pytest.mark.parametrize("case", ["stencil", "rgl_span2"])
def test_profile_bslab_csr_equals_the_plain_version(case):
    """profile_bslab's cuSPARSE yardstick is the same matrix: its CSR form,
    built from the slices, times x equals the plain version on the CPU, to
    1e-5 (f32: the CSR product sums each row in another order)."""
    from sparsebench_tpu_torch.profile_bslab import csr_of

    A = bslab_case(case, CPU)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        A.nc).astype(np.float32))
    y = bslab_spmv_torch(A.slices, x, sub=A.sub, lead=A.lead,
                         x_rows=A.x_rows).reshape(-1)[:A.nr]
    torch.testing.assert_close(csr_of(A) @ x, y, rtol=1e-5, atol=1e-5)


def test_profile_bslab_refuses_unknown_cases_and_the_cpu(monkeypatch):
    from sparsebench_tpu_torch import profile_bslab

    with pytest.raises(SystemExit):
        profile_bslab.main(["--cases", "100,300"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_bslab.main(["--cases", "100"])
