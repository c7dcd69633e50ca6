"""Port parity: the BSLAB format of sparsebench_tpu_torch against the JAX
package, on the CPU.

The layout is built by numpy copies of the JAX package's host code (and by
torch ops for the stencil), so every array comes out equal, element for
element (np.array_equal, bf16 compared as f32): slice metadata, value,
index and block planes, the window plan and the bf16 compression decision.
The SpMV (the plain version ``bslab_spmv_torch``, which the kernels K6/K7
equal bit for bit on the card) is held against the JAX Pallas kernels in
interpret mode, whole-x and windowed, to 1e-13 (f64) and 1e-6 (f32) of
max_i (|A||x|)_i: the two sum the same products in other orders.
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats.base import (  # noqa: E402
    physical_spmv_bytes as jax_physical_spmv_bytes,
)
from sparsebench_tpu.formats.bslab import BslabMatrix as JaxBslab  # noqa: E402
from sparsebench_tpu.host import HostCSR as JaxCSR  # noqa: E402
from sparsebench_tpu.host import generate_stencil as jax_generate  # noqa: E402
from sparsebench_tpu.host import read_mm as jax_read_mm  # noqa: E402
from sparsebench_tpu_torch import host  # noqa: E402
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats import get_format  # noqa: E402
from sparsebench_tpu_torch.formats.base import physical_spmv_bytes  # noqa: E402
from sparsebench_tpu_torch.formats.bslab import BslabMatrix  # noqa: E402
from sparsebench_tpu_torch.ops.bslab_spmv import (  # noqa: E402
    bslab_spmv,
    bslab_spmv_torch,
    bslab_spmv_win,
)

CPU = torch.device("cpu")
TOL = {"f64": 1e-13, "f32": 1e-6}
NP_DT = {"f64": np.float64, "f32": np.float32}
ARRAYS = ("meta_aff", "vals_aff", "meta_gen", "vals_gen", "lidx_gen",
          "meta_wide", "vals_wide", "lidx_wide", "dblk_wide", "wchunk")
FIELDS = ("nr", "nc", "nnz", "n_tiles", "s_aff", "s_gen", "s_wide",
          "wide_k", "sub", "x_rows", "w_blocks", "xw_rows", "n_elems",
          "start_row", "total_nr", "total_nnz", "wide_groups")


def values(a):
    """A numpy array's values, bf16 (ml_dtypes) widened to f32."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def torch_values(t):
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def assert_same_bslab(At, Aj):
    """Every array and layout field of the port's matrix equals JAX's."""
    for f in FIELDS:
        assert getattr(At, f) == getattr(Aj, f), f
    for f in ARRAYS:
        t, j = getattr(At, f), np.asarray(getattr(Aj, f))
        assert tuple(t.shape) == j.shape, f
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, f
        np.testing.assert_array_equal(torch_values(t), values(j), err_msg=f)


def to_port(cj) -> host.HostCSR:
    return host.HostCSR(row_ptr=cj.row_ptr.copy(), col=cj.col.copy(),
                        val=cj.val.copy(), nr=cj.nr, nc=cj.nc,
                        start_row=cj.start_row, total_nr=cj.total_nr,
                        total_nnz=cj.total_nnz)


def random_csr(nr, nc, density, seed, band=None):
    """A random JAX HostCSR (rows column-sorted)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((nr, nc)) < density
    if band is not None:
        mask &= np.abs(np.arange(nr)[:, None] - np.arange(nc)[None, :]) <= band
    r, c = np.nonzero(mask)
    row_ptr = np.zeros(nr + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=nr), out=row_ptr[1:])
    return JaxCSR(row_ptr=row_ptr, col=c.astype(np.int64),
                  val=rng.standard_normal(r.size), nr=nr, nc=nc)


def unsorted_csr():
    """Two rows whose columns are not sorted (the build's guard)."""
    return JaxCSR(row_ptr=np.array([0, 3, 5]), col=np.array([5, 2, 9, 7, 3]),
                  val=np.array([1.0, 2.0, 3.0, 4.0, 5.0]), nr=2, nc=12)


def empty_csr():
    return JaxCSR(row_ptr=np.zeros(11, np.int64), col=np.zeros(0, np.int64),
                  val=np.zeros(0), nr=10, nc=10)


def read(name):
    import pathlib

    path = pathlib.Path(__file__).parent / "data" / name
    return JaxCSR.from_coo(jax_read_mm(str(path)))


CSR_CASES = {
    "stencil10x9x7": lambda: jax_generate(10, 9, 7),
    "stencil16": lambda: jax_generate(16, 16, 16),
    "klein": lambda: read("matrix_band_klein.mtx"),
    "random": lambda: random_csr(300, 300, 0.02, 0),
    "rect": lambda: random_csr(130, 260, 0.05, 2),
    "banded": lambda: random_csr(500, 500, 0.3, 1, band=40),
    "unsorted": unsorted_csr,
    "empty": empty_csr,
    **{f"test{i}": (lambda i=i: read(f"testMatrices/test{i}.mtx"))
       for i in range(11)},
}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_from_csr_arrays_equal_jax(case, dtype):
    """Default slice height; f32 values compress to bf16 where lossless."""
    cj = CSR_CASES[case]()
    Aj = JaxBslab.from_csr(cj, JaxPolicy.from_names(dtype, "i32"), impl="xla")
    At = BslabMatrix.from_csr(to_port(cj), DTypePolicy.from_names(dtype),
                              device=CPU)
    assert_same_bslab(At, Aj)
    assert At.impl == "torch"


@pytest.mark.parametrize("sub", [8, 16, 64])
@pytest.mark.parametrize("case", ["stencil10x9x7", "stencil16", "random"])
def test_from_csr_slice_heights_equal_jax(case, sub):
    cj = CSR_CASES[case]()
    Aj = JaxBslab.from_csr(cj, JaxPolicy.from_names("f32", "i32"), impl="xla",
                           sub=sub)
    At = BslabMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f32"),
                              device=CPU, sub=sub)
    assert_same_bslab(At, Aj)


def test_bf16_compression_decision_equals_jax():
    """Values that bf16 cannot hold stay f32, in both packages; values it
    can hold are stored bf16; compress=False keeps f32."""
    cj = random_csr(300, 300, 0.02, 0)
    cj_int = JaxCSR(row_ptr=cj.row_ptr, col=cj.col,
                    val=np.round(cj.val * 8), nr=cj.nr, nc=cj.nc)
    for c, want in ((cj, torch.float32), (cj_int, torch.bfloat16)):
        Aj = JaxBslab.from_csr(c, JaxPolicy.from_names("f32", "i32"))
        At = BslabMatrix.from_csr(to_port(c), DTypePolicy.from_names("f32"),
                                  device=CPU)
        assert At.vals_aff.dtype == want
        assert_same_bslab(At, Aj)
    At = BslabMatrix.from_csr(to_port(cj_int), DTypePolicy.from_names("f32"),
                              device=CPU, compress=False)
    assert At.vals_aff.dtype == torch.float32


def test_min_slice_counts_pad_like_jax():
    cj = random_csr(300, 300, 0.02, 0)
    Aj = JaxBslab.from_csr(cj, JaxPolicy.from_names("f64", "i32"),
                           impl="xla", min_s_aff=9, min_s_gen=40)
    At = BslabMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f64"),
                              device=CPU, min_s_aff=9, min_s_gen=40)
    assert At.s_gen == 40
    assert_same_bslab(At, Aj)


STENCIL_CASES = [
    ((10, 9, 7), False, 0), ((10, 9, 7), True, 0), ((16, 16, 16), False, 8),
    ((8, 8, 20), True, 8), ((2, 2, 5), False, 0), ((1, 5, 6), True, 8),
]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("dims,use_7pt,sub", STENCIL_CASES)
def test_from_stencil_equals_jax(dims, use_7pt, sub, dtype):
    """27 and 7 points, several tiles at sub 8, and the collision fallback
    (2x2x5 and 1x5x6 alias shifts onto one diagonal)."""
    Aj, cj = JaxBslab.from_stencil(*dims, use_7pt=use_7pt, sub=sub,
                                   policy=JaxPolicy.from_names(dtype, "i32"),
                                   impl="xla")
    At, ct = BslabMatrix.from_stencil(*dims, use_7pt=use_7pt, sub=sub,
                                      policy=DTypePolicy.from_names(dtype),
                                      device=CPU)
    np.testing.assert_array_equal(ct, np.asarray(cj))
    assert_same_bslab(At, Aj)


def assert_spmv_close(y, y_ref, bound, dtype):
    err = np.abs(np.asarray(y, np.float64) - np.asarray(y_ref, np.float64))
    assert err.max() <= TOL[dtype] * bound.max()


SPMV_CASES = ["stencil10x9x7", "klein", "random", "rect", "banded",
              "test0", "test8"]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("impl", ["pallas_interpret", "pallas_win_interpret"])
@pytest.mark.parametrize("case", SPMV_CASES)
def test_spmv_matches_jax_kernels(case, impl, dtype):
    cj = CSR_CASES[case]()
    jp = JaxPolicy.from_names(dtype, "i32")
    Aj = JaxBslab.from_csr(cj, jp, impl=impl, sub=8)
    At = BslabMatrix.from_csr(to_port(cj), DTypePolicy.from_names(dtype),
                              device=CPU, sub=8)
    x = np.random.default_rng(cj.nr).standard_normal(cj.nc).astype(
        NP_DT[dtype])
    y_j = np.asarray(jax.jit(lambda A, v: A.spmv(v))(Aj, jnp.asarray(x)))
    y_t = At.spmv(torch.from_numpy(x))
    assert y_t.dtype == torch.from_numpy(x).dtype and y_t.shape == (cj.nr,)
    bound = to_port(cj)
    bound.val = np.abs(bound.val)
    assert_spmv_close(y_t.numpy(), y_j, bound.spmv(np.abs(x)), dtype)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_stencil_spmv_matches_jax_windowed_kernel(dtype):
    """The analytic stencil build, two tiles, through JAX's windowed
    kernel."""
    jp = JaxPolicy.from_names(dtype, "i32")
    Aj, _ = JaxBslab.from_stencil(8, 8, 20, policy=jp,
                                  impl="pallas_win_interpret")
    At, counts = BslabMatrix.from_stencil(8, 8, 20, device=CPU,
                                          policy=DTypePolicy.from_names(dtype))
    x = np.random.default_rng(3).standard_normal(At.nr).astype(NP_DT[dtype])
    y_j = np.asarray(Aj.spmv(jnp.asarray(x)))
    y_t = At.spmv(torch.from_numpy(x)).numpy()
    bound = 27 * np.abs(x).max() + np.abs(x).max() * (counts - 1)
    assert_spmv_close(y_t, y_j, bound, dtype)


def test_plain_version_sums_slices_in_order():
    """The plain version adds one slice at a time in stored order: a
    hand-checked two-tile layout with one slice of each class."""
    from sparsebench_tpu_torch.ops.bslab_spmv import Slices

    sub, lead = 8, 8
    z = lambda *s, dt=torch.float64: torch.zeros(s, dtype=dt)  # noqa: E731
    vals = z(1, 1, sub, 128)
    vals[0, 0, 0, 0] = 2.0            # affine: row 0 reads x[0 + r]
    gvals = z(1, 1, sub, 128)
    gvals[0, 0, 0, 1] = 3.0           # general: row 1 reads x[5]
    glidx = z(1, 1, sub, 128, dt=torch.int8)
    glidx[0, 0, 0, 1] = 5
    wvals = z(1, 1, sub, 128)
    wvals[0, 0, 1, 2] = 4.0           # wide: row 130 reads x[(1+1)*128 + 7]
    wl = z(1, 1, sub, 128, dt=torch.int8)
    wl[0, 0, 1, 2] = 7
    wd = z(1, 1, sub, 128, dt=torch.int8)
    wd[0, 0, 1, 2] = 1
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    sl = Slices(i32(lead, 3).reshape(1, 1, 2), vals,
                i32(lead).reshape(1, 1, 1), gvals, glidx,
                i32(lead).reshape(1, 1, 1), wvals, wl, wd)
    x = torch.arange(1.0, 300.0, dtype=torch.float64)
    y = bslab_spmv_torch(sl, x, sub=sub, lead=lead, x_rows=lead + 3 + sub)
    y = y.reshape(-1)
    assert y[0] == 2.0 * x[3] and y[1] == 3.0 * x[5]
    assert y[130] == 4.0 * x[2 * 128 + 7]
    assert int((y != 0).sum()) == 3


def test_impl_resolution_on_the_cpu():
    csr = to_port(jax_generate(5, 4, 3))
    f32 = DTypePolicy.from_names("f32")
    assert BslabMatrix.from_csr(csr, f32, device=CPU).impl == "torch"
    assert BslabMatrix.from_csr(csr, f32, device=CPU,
                                impl="torch").impl == "torch"
    for impl in ("kernel", "kernel_win"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            BslabMatrix.from_csr(csr, f32, device=CPU, impl=impl)
    with pytest.raises(ValueError, match="unknown bslab impl"):
        BslabMatrix.from_csr(csr, f32, device=CPU, impl="pallas")
    with pytest.raises(ValueError, match="multiple of 8"):
        BslabMatrix.from_csr(csr, f32, device=CPU, sub=12)
    assert get_format("bslab") is BslabMatrix


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers launch a kernel or raise: on the CPU the matrix's impl
    'torch' runs the plain version, and the wrappers never choose it."""
    A, _ = BslabMatrix.from_stencil(5, 4, 3, device=CPU)
    x = torch.ones(A.nc)
    before = (bslab_spmv.launches, bslab_spmv_win.launches)
    with pytest.raises(ValueError, match="CUDA device"):
        bslab_spmv(A.slices, x, sub=A.sub, lead=A.lead)
    with pytest.raises(ValueError, match="CUDA device"):
        bslab_spmv_win(A.wchunk, A.slices, x, sub=A.sub, lead=A.lead,
                       w_blocks=A.w_blocks)
    assert (bslab_spmv.launches, bslab_spmv_win.launches) == before


@pytest.mark.parametrize("case", ["stencil10x9x7", "random", "empty"])
def test_physical_bytes_equal_jax(case):
    cj = CSR_CASES[case]()
    Aj = JaxBslab.from_csr(cj, JaxPolicy.from_names("f32", "i32"))
    At = BslabMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f32"),
                              device=CPU)
    assert physical_spmv_bytes(At, 4) == jax_physical_spmv_bytes(Aj, 4)
    assert At.padding_ratio == Aj.padding_ratio
