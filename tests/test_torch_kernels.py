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
    win_fits,
)
from sparsebench_tpu_torch.ops.cg_fused import cs_update, cs_update_torch
from sparsebench_tpu_torch.ops.dia_spmm import dia_spmm, dia_spmm_torch
from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_torch
from sparsebench_tpu_torch.ops.memroof import (
    measure_dma_read_gbps,
    read_passes,
    read_passes_torch,
)
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
        "bsell_spmv.cu", "bslab_spmv.cu", "cg_fused.cu", "csr_twopass.cu",
        "dia_spmm.cu", "dia_spmv.cu", "dia_window.cu", "memroof.cu",
        "slab_slices.cu", "stencil.cu", "stencil_cg_vmem.cu"]
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


STENCIL_CASES = [((10, 9, 7), False), ((8, 8, 8), True), ((1, 1, 1), False),
                 ((130, 2, 3), False), ((128, 5, 4), True), ((1, 5, 6), False)]


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
@pytest.mark.parametrize("case", STENCIL_CASES)
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
@pytest.mark.parametrize("case", STENCIL_CASES[:4])
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
@pytest.mark.parametrize("dims,use_7pt,eps", [((10, 9, 8), False, 0.0),
                                              ((8, 8, 8), True, 1e-8),
                                              ((40, 30, 20), False, 0.0),
                                              ((100, 100, 100), False, 0.0)])
def test_vmem_kernel_matches_plain(dims, use_7pt, eps, dt, cuda_device):
    """K5 against its plain version: k equal, the history to rtol 1e-9
    (f64; 1e-4 in f32) above its noise floor, one launch per solve."""
    A, counts = StencilOperator.from_stencil(*dims, use_7pt=use_7pt,
                                             device=cuda_device)
    b = torch.from_numpy(27.0 - (counts - 1.0)).to(cuda_device, DT[dt])
    x0 = torch.zeros_like(b)
    r0 = b - A.spmv(x0)
    before = stencil_cg_vmem.launches
    x, h = stencil_cg_vmem(r0, x0, eps, *dims, 40, use_7pt)
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
    """K7 needs its 2W-row window in a block's 227 KB: f32 fits where f64
    may not, and the wrapper's refusal names the size."""
    A = bslab_case("rgl", CPU)
    sl = A.slices
    assert win_fits(sl, A.w_blocks, torch.float32)
    assert win_fits(sl, 224, torch.float32)       # 100^3 at sub 64
    assert not win_fits(sl, 224, torch.float64)
    assert not win_fits(sl, 760, torch.float32)   # 200^3 at sub 128


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
    if win_fits(sl, A.w_blocks, x.dtype):
        before = bslab_spmv_win.launches
        y = bslab_spmv_win(A.wchunk, sl, x, sub=A.sub, lead=A.lead,
                           w_blocks=A.w_blocks)
        assert bslab_spmv_win.launches == before + 1
        assert_bits_equal(y, y_ref)


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
    with pytest.raises(ValueError, match="shared memory"):
        bslab_spmv_win(A.wchunk, A.slices, x, sub=A.sub, lead=A.lead,
                       w_blocks=1000)


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


def assert_spmm_is_k1_column_by_column(data, X, offsets, nr):
    before = dia_spmm.launches
    Y = dia_spmm(data, X, offsets, nr)
    assert dia_spmm.launches == before + 1
    assert_bits_equal(Y, dia_spmm_torch(data, X, offsets, nr))
    for c in range(X.shape[0]):
        assert_bits_equal(Y[c], dia_spmv(data, X[c].contiguous(), offsets, nr))


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
@pytest.mark.parametrize("offsets,nr", [((-1000, -1, 0, 1, 999), 8192),
                                        ((0,), 1), ((-3, 5), 7)])
def test_spmm_kernel_on_edge_offsets(pair, offsets, nr, cuda_device):
    rng = np.random.default_rng(nr)
    data = torch.from_numpy(rng.standard_normal((len(offsets), max(nr, 128))))
    X = torch.from_numpy(rng.standard_normal((3, nr)))
    assert_spmm_is_k1_column_by_column(
        data.to(device=cuda_device, dtype=DT[pair[0]]),
        X.to(device=cuda_device, dtype=DT[pair[1]]), offsets, nr)


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
    """K10 and K11 need the 2W-row window in a block's 227 KB: the CLI's
    100^3 build (W 168) fits in f32 and not in f64; 200^3 on the device
    (W 640) does not fit."""
    assert bsell_ops.win_smem_bytes(168, torch.float32) == 172_032
    assert bsell_ops.win_fits(168, torch.float32)
    assert not bsell_ops.win_fits(168, torch.float64)
    assert not bsell_ops.win_fits(640, torch.float32)


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
        with pytest.raises(ValueError, match="655360 B of shared memory"):
            fn(A.wchunk, A.blocks, x2d, A.vals, A.lidx, w_blocks=640)
        assert fn.launches == before


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
