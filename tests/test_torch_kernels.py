"""The DIA SpMV kernel of sparsebench_tpu_torch: its wrapper, its build and,
on a CUDA card, the kernel itself — without the JAX package.

Here on the CPU the dispatch, the refusals and the build lookup run; the
tests marked ``cuda`` skip without a card. On a machine with an NVIDIA
GPU and nvcc, which need not be able to import the JAX package, run the
whole file with

    python -m pytest tests/test_torch_kernels.py --noconftest -p no:cacheprovider

(``--noconftest``: tests/conftest.py sets up JAX for the other tests).

The kernel rounds each product and sum in the plain version's order, so
the stated bound ndiag * eps * (|A||x|)_i — any summation order, with or
without FMA contraction — is expected to hold with equality at 0.
"""

import numpy as np
import pytest
import torch

from sparsebench_tpu_torch import cli
from sparsebench_tpu_torch.config import DTypePolicy, resolve_device
from sparsebench_tpu_torch.formats import get_format
from sparsebench_tpu_torch.formats.dia import DiaMatrix, resolve_impl
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_torch
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
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        get_format("bslab")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 6"):
        get_format("stencil")
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
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    src.write_text("// two\n")
    assert _build.library_path() != first
    assert _build.library_path().parent == _build.BUILD_DIR


def test_kernel_sources_are_found():
    assert [p.name for p in _build.sources()] == ["dia_spmv.cu"]
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


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
