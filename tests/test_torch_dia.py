"""Port parity: DIA format and SpMV of sparsebench_tpu_torch against the JAX
package, on the CPU.

The JAX side runs as its own tests run it: the ``xla`` path
(``DiaMatrix._spmv_xla``) and the Pallas kernel in interpret mode
(``dia_spmv_pallas(..., interpret=True)``). Inputs are made with numpy from
a seed and handed to both. The port's CUDA kernel, its wrapper and its
build are tested without JAX in tests/test_torch_kernels.py.

Tolerances: the matrix build is exact (bit-equal data, equal offsets and
row counts). The SpMV sums the same terms; the orders of rounding differ
(XLA may contract to FMA, the Pallas kernel sums through lane rolls), so
results agree to rtol 1e-13 in f64 and 1e-6 in f32, relative to max|y|.
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats.base import (  # noqa: E402
    physical_spmv_bytes as jax_physical_spmv_bytes,
)
from sparsebench_tpu.formats.dia import DiaMatrix as JaxDia  # noqa: E402
from sparsebench_tpu.host import HostCSR, generate_stencil, read_mm  # noqa: E402
from sparsebench_tpu.ops import dia_pallas  # noqa: E402
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats import from_csr  # noqa: E402
from sparsebench_tpu_torch.formats.base import physical_spmv_bytes  # noqa: E402
from sparsebench_tpu_torch.formats.dia import (  # noqa: E402
    DiaMatrix,
    DiaUnsuitableError,
)
from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv_torch  # noqa: E402

CPU = torch.device("cpu")
RTOL = {"f64": 1e-13, "f32": 1e-6}
NP_DT = {"f64": np.float64, "f32": np.float32}


def jax_policy(name):
    return JaxPolicy.from_names(name, "i32")


def policy(name):
    return DTypePolicy.from_names(name)


def bits(a):
    """Comparable bits of a numpy array (ml_dtypes bf16 as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def torch_bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def assert_same_matrix(At, Aj):
    assert At.offsets == Aj.offsets
    for f in ("nr", "nc", "nnz", "n_elems", "nr_pad", "start_row",
              "total_nr", "total_nnz"):
        assert getattr(At, f) == getattr(Aj, f), f
    data_j = np.asarray(Aj.data).reshape(len(Aj.offsets), Aj.nr_pad)
    assert tuple(At.data.shape) == data_j.shape
    assert str(At.data.dtype).removeprefix("torch.") == data_j.dtype.name
    np.testing.assert_array_equal(torch_bits(At.data), bits(data_j))


def klein(data_dir):
    return HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))


def assert_close(y, y_ref, dtype):
    y_ref = np.asarray(y_ref, dtype=np.float64)
    rtol = RTOL[dtype]
    np.testing.assert_allclose(
        np.asarray(y, dtype=np.float64), y_ref, rtol=rtol,
        atol=rtol * max(1.0, np.abs(y_ref).max()),
    )


# -- (a) build -----------------------------------------------------------


@pytest.mark.parametrize("dims", [(10, 9, 7), (8, 8, 8), (5, 4, 3),
                                  (2, 2, 3)])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("use_7pt", [False, True])
def test_from_stencil_matches_jax(dims, dtype, use_7pt):
    """Data (bf16 under the f32 policy), offsets, row counts and sizes equal
    the JAX package's bit for bit; (2, 2, 3) takes the degenerate-grid CSR
    path."""
    Aj, cj = JaxDia.from_stencil(*dims, use_7pt=use_7pt,
                                 policy=jax_policy(dtype), impl="xla")
    At, ct = DiaMatrix.from_stencil(*dims, use_7pt=use_7pt,
                                    policy=policy(dtype), device=CPU)
    assert_same_matrix(At, Aj)
    np.testing.assert_array_equal(np.asarray(ct), np.asarray(cj))
    assert At.impl == "torch"


@pytest.mark.parametrize("source", ["klein", "stencil"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("compress", [True, False])
def test_from_csr_matches_jax(source, dtype, compress, data_dir):
    csr = klein(data_dir) if source == "klein" else generate_stencil(6, 5, 4)
    Aj = JaxDia.from_csr(csr, jax_policy(dtype), impl="xla",
                         compress=compress)
    At = from_csr("dia", csr, policy(dtype), device=CPU, compress=compress)
    assert_same_matrix(At, Aj)
    assert physical_spmv_bytes(At, 4) == jax_physical_spmv_bytes(Aj, 4)


def test_from_csr_unsuitable():
    csr = generate_stencil(6, 5, 4)
    with pytest.raises(DiaUnsuitableError):
        DiaMatrix.from_csr(csr, device=CPU, max_diags=26)
    rect = HostCSR(row_ptr=np.array([0, 1, 2]), col=np.array([0, 2]),
                   val=np.array([1.0, 1.0]), nr=2, nc=3)
    with pytest.raises(DiaUnsuitableError):
        DiaMatrix.from_csr(rect, device=CPU)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_physical_bytes_match_jax(dtype):
    Aj, _ = JaxDia.from_stencil(12, 11, 10, policy=jax_policy(dtype),
                                impl="xla")
    At, _ = DiaMatrix.from_stencil(12, 11, 10, policy=policy(dtype),
                                   device=CPU)
    xb = 8 if dtype == "f64" else 4
    assert physical_spmv_bytes(At, xb) == jax_physical_spmv_bytes(Aj, xb)


# -- (b) SpMV ------------------------------------------------------------


def _spmv_cases():
    cases = []
    for dims in [(10, 9, 7), (8, 8, 8)]:
        for dtype in ("f32", "f64"):
            cases.append(("stencil", dims, dtype))
    for dtype in ("f32", "f64"):
        cases.append(("klein", None, dtype))
    return cases


@pytest.mark.parametrize("kind,dims,dtype", _spmv_cases())
def test_spmv_matches_jax(kind, dims, dtype, data_dir):
    """The port's plain SpMV against JAX's xla path and its Pallas kernel in
    interpret mode, on the same matrix and x."""
    jp = jax_policy(dtype)
    if kind == "stencil":
        Aj, _ = JaxDia.from_stencil(*dims, policy=jp, impl="xla")
    else:
        Aj = JaxDia.from_csr(klein(data_dir), jp, impl="xla")
    At = DiaMatrix.from_jax_arrays(
        np.asarray(Aj.data), Aj.offsets, Aj.nr, Aj.nc, Aj.nnz, Aj.nr_pad,
        device=CPU, impl="torch",
    )
    x = np.random.default_rng(7).standard_normal(Aj.nr).astype(NP_DT[dtype])
    y_t = At.spmv(torch.from_numpy(x)).numpy()
    assert y_t.dtype == x.dtype

    y_xla = np.asarray(Aj.spmv(x))
    assert_close(y_t, y_xla, dtype)

    # the JAX kernel path as the CLI runs it: choose_schedule, pack_x,
    # dia_spmv_pallas (here in interpret mode)
    y_pl = np.asarray(Aj.replace(impl="pallas_interpret").spmv(x))
    assert_close(y_t, y_pl, dtype)


@pytest.mark.parametrize(
    "offsets", [(0,), (-1, 1), (-128, 128), (-257, 0, 257), (-1000, 999)]
)
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_spmv_shift_patterns_match_jax(offsets, dtype):
    """Synthetic diagonals (tests/test_dia_pallas_kernel.py shift patterns):
    the port's plain SpMV against the JAX xla path (f32 and f64) and the
    Pallas kernel in interpret mode (f32)."""
    nr_pad = 128 * 64
    rng = np.random.default_rng(abs(hash(offsets)) % 2**31)
    data = rng.standard_normal((len(offsets), nr_pad)).astype(NP_DT[dtype])
    x = (np.arange(nr_pad) * 0.001).astype(NP_DT[dtype])
    y_t = dia_spmv_torch(torch.from_numpy(data), torch.from_numpy(x),
                         offsets, nr_pad).numpy()

    Aj = JaxDia(data=jax.numpy.asarray(data.reshape(len(offsets), -1, 128)),
                offsets=offsets, nr=nr_pad, nc=nr_pad, nnz=0,
                n_elems=len(offsets) * nr_pad, nr_pad=nr_pad, impl="xla")
    assert_close(y_t, np.asarray(Aj.spmv(x)), dtype)
    if dtype == "f32":
        y_pl = np.asarray(dia_pallas.dia_spmv_pallas(
            Aj.data, dia_pallas.pack_x(x, offsets, nr_pad), offsets, nr_pad,
            interpret=True,
        )).reshape(-1)[:nr_pad]
        assert_close(y_t, y_pl, dtype)


def test_spmv_bf16_vector_matches_jax_kernel_path():
    """bf16 x is widened to f32 for the sum and the result narrowed, as on
    the JAX kernel path (formats/dia.py:357-375): same bf16 bits."""
    Aj, _ = JaxDia.from_stencil(8, 8, 8, policy=jax_policy("f32"),
                                impl="pallas_interpret")
    At, _ = DiaMatrix.from_stencil(8, 8, 8, policy=policy("f32"), device=CPU)
    x = np.random.default_rng(3).standard_normal(At.nr).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y_t = At.spmv(xt)
    assert y_t.dtype == torch.bfloat16
    xj = jax.numpy.asarray(xt.float().numpy()).astype(jax.numpy.bfloat16)
    y_j = np.asarray(Aj.spmv(xj))
    np.testing.assert_array_equal(torch_bits(y_t), bits(y_j))


# -- (c) carry-over ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("source", ["stencil", "klein"])
def test_from_jax_arrays_round_trip(dtype, source, data_dir):
    """from_jax_arrays rebuilds the JAX matrix exactly (bf16 included), and
    the bits go back to a JAX array unchanged."""
    jp = jax_policy(dtype)
    if source == "stencil":
        Aj, _ = JaxDia.from_stencil(9, 8, 7, policy=jp, impl="xla")
    else:
        Aj = JaxDia.from_csr(klein(data_dir), jp, impl="xla")
    At = DiaMatrix.from_jax_arrays(
        np.asarray(Aj.data), Aj.offsets, Aj.nr, Aj.nc, Aj.nnz, Aj.nr_pad,
        Aj.start_row, Aj.total_nr, Aj.total_nnz, device=CPU, impl="auto",
    )
    assert_same_matrix(At, Aj)
    back = torch_bits(At.data).reshape(np.asarray(Aj.data).shape)
    if np.asarray(Aj.data).dtype.name == "bfloat16":
        back = back.view(np.asarray(Aj.data).dtype)
    np.testing.assert_array_equal(bits(jax.numpy.asarray(back)),
                                  bits(Aj.data))
