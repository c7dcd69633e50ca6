"""Port parity: the BSELL format of sparsebench_tpu_torch against the JAX
package, on the CPU.

The host layout is a numpy copy of the JAX package's ``_build_arrays`` and
the stencil layout the same iota arithmetic in torch, so every array comes
out equal, element for element: values (bf16 compared as f32), lane
indices, block table, window base and chunk, and the layout's counts. The
JAX ``from_csr`` may take its native C++ build, which gives the numpy build's
arrays, so its values are compared as f32 and its indices as integers.
The plain SpMV ``bsell_spmv_torch`` (which K9-K11 equal bit for bit on the
card, tests/test_torch_kernels.py) is held against all four JAX paths, the
XLA gather and the Pallas kernels in interpret mode: to 1e-12 of
max_i (|A||x|)_i in f64 and 1e-6 in f32 with bf16 values, the two summing
the same products in other orders. The CLI's ``--fmt bsell`` runs are held
to the JAX CLI's: f64 residual lines above 1e-10 of the first to the 7
digits they print, and the difference line exactly.
"""

import re
import time

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from sparsebench_tpu import cli as jax_cli  # noqa: E402
from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats import bsell as jax_bsell  # noqa: E402
from sparsebench_tpu.formats.base import (  # noqa: E402
    physical_spmv_bytes as jax_physical_spmv_bytes,
)
from sparsebench_tpu.host import HostCSR as JaxCSR  # noqa: E402
from sparsebench_tpu.host import generate_stencil as jax_generate  # noqa: E402
from sparsebench_tpu.host import native as jax_native  # noqa: E402
from sparsebench_tpu.host import read_mm as jax_read_mm  # noqa: E402
from sparsebench_tpu.host.rcm import permute_csr as jax_permute  # noqa: E402
from sparsebench_tpu.host.rcm import rcm_permutation as jax_rcm  # noqa: E402
from sparsebench_tpu.solvers.cg import solve_cg as jax_solve_cg  # noqa: E402
from sparsebench_tpu_torch import cli, host  # noqa: E402
from sparsebench_tpu_torch.config import DTypePolicy  # noqa: E402
from sparsebench_tpu_torch.formats import bsell, get_format  # noqa: E402
from sparsebench_tpu_torch.formats.base import (  # noqa: E402
    physical_spmv_bytes,
)
from sparsebench_tpu_torch.formats.bsell import BsellMatrix  # noqa: E402
from sparsebench_tpu_torch.ops.bsell_spmv import (  # noqa: E402
    bsell_spmv,
    bsell_spmv_torch,
    bsell_spmv_win2,
    bsell_spmv_windowed,
)
from sparsebench_tpu_torch.solvers.cg import solve_cg  # noqa: E402

CPU = torch.device("cpu")
TOL = {"f64": 1e-12, "f32": 1e-6}
ARRAYS = ("vals", "lidx", "blocks", "win_base", "wchunk")
FIELDS = ("nr", "nc", "nnz", "n_tiles", "s_max", "nc_pad", "w_blocks",
          "xw_rows", "n_elems", "start_row", "total_nr", "total_nnz")
JAX_SPMV_IMPLS = ("xla", "pallas_interpret", "pallas_win_interpret",
                  "pallas_win2_interpret")


def values(a):
    """An array's values as numpy, bf16 widened to f32."""
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_same_bsell(At, Aj, dtypes: bool = True):
    """Every array and layout field of the port's matrix equals JAX's;
    with ``dtypes`` the stored dtypes too."""
    for f in FIELDS:
        assert getattr(At, f) == getattr(Aj, f), f
    for f in ARRAYS:
        t, j = getattr(At, f), np.asarray(getattr(Aj, f))
        assert tuple(t.shape) == j.shape, f
        if dtypes:
            assert str(t.dtype).removeprefix("torch.") == j.dtype.name, f
        if f == "vals":
            np.testing.assert_array_equal(values(t), values(j), err_msg=f)
        else:
            np.testing.assert_array_equal(values(t).astype(np.int64),
                                          j.astype(np.int64), err_msg=f)


def to_port(cj) -> host.HostCSR:
    return host.HostCSR(row_ptr=cj.row_ptr.copy(), col=cj.col.copy(),
                        val=cj.val.copy(), nr=cj.nr, nc=cj.nc,
                        start_row=cj.start_row, total_nr=cj.total_nr,
                        total_nnz=cj.total_nnz)


def read(name):
    import pathlib

    path = pathlib.Path(__file__).parent / "data" / name
    return JaxCSR.from_coo(jax_read_mm(str(path)))


def scrambled_and_restored(restore: bool):
    """The 32x8x8 stencil with its rows and columns shuffled (locality
    destroyed) and, with ``restore``, reordered by RCM again
    (tests/test_cg.py:199-225)."""
    base = jax_generate(32, 8, 8)
    shuffle = np.random.default_rng(7).permutation(base.nr)
    scrambled = jax_permute(base, shuffle)
    return jax_permute(scrambled, jax_rcm(scrambled)) if restore else scrambled


def empty_csr():
    return JaxCSR(row_ptr=np.zeros(11, np.int64), col=np.zeros(0, np.int64),
                  val=np.zeros(0), nr=10, nc=10)


def banded_csr():
    """4 tiles of a random banded matrix, 3500 rows, band 150, numpy-seeded
    (W 16, the last tile's window at chunk 1)."""
    rng = np.random.default_rng(1)
    n = 3500
    rows = np.repeat(np.arange(n), 2)
    cols = np.clip(rows + rng.integers(-150, 151, rows.size), 0, n - 1)
    keys = np.unique(np.concatenate([rows * n + cols, np.arange(n) * (n + 1)]))
    r, c = keys // n, keys % n
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=row_ptr[1:])
    return JaxCSR(row_ptr=row_ptr, col=c.astype(np.int64),
                  val=rng.standard_normal(r.size), nr=n, nc=n)


def wide_csr():
    """nc > nr: 300 rows, 2000 columns, numpy-seeded, rows column-sorted."""
    rng = np.random.default_rng(5)
    mask = rng.random((300, 2000)) < 0.01
    r, c = np.nonzero(mask)
    row_ptr = np.zeros(301, np.int64)
    np.cumsum(np.bincount(r, minlength=300), out=row_ptr[1:])
    return JaxCSR(row_ptr=row_ptr, col=c.astype(np.int64),
                  val=rng.standard_normal(r.size), nr=300, nc=2000)


CSR_CASES = {
    "klein": lambda: read("matrix_band_klein.mtx"),
    **{f"test{i}": (lambda i=i: read(f"testMatrices/test{i}.mtx"))
       for i in range(11)},
    "stencil5x4x3": lambda: jax_generate(5, 4, 3),
    "stencil7x6x5": lambda: jax_generate(7, 6, 5),
    "stencil5x4x3_7pt": lambda: jax_generate(5, 4, 3, use_7pt=True),
    "stencil7x6x5_7pt": lambda: jax_generate(7, 6, 5, use_7pt=True),
    "scrambled32x8x8": lambda: scrambled_and_restored(False),
    "rcm32x8x8": lambda: scrambled_and_restored(True),
    "empty": empty_csr,
    "wide": wide_csr,
    "banded4t": banded_csr,
}


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_build_arrays_equal_jax(case, dtype):
    """The numpy build: every array and n_tiles, s_max, nc_pad, w_blocks,
    xw_rows equal, dtypes included."""
    cj = CSR_CASES[case]()
    want = jax_bsell._build_arrays(cj, JaxPolicy.from_names(dtype, "i32"))
    got = bsell._build_arrays(to_port(cj),
                              DTypePolicy.from_names(dtype).host_value)
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.fixture(scope="module")
def jax_native_build():
    """The JAX package's native host library, loaded before its
    ``from_csr`` runs. That build takes the native C++ path where the
    library loads and its numpy path where it does not, and the two store
    an empty f32 matrix differently: the native path as f32 (no entry to
    compress, the port's rule), the numpy path as bf16 (its zero padding
    round-trips). The library is built by ``make`` at first use; where
    several test processes start at once, one may find another's
    half-written file, fail to load it and take the numpy path. So load it
    here, looking again while another process may still be writing it."""
    deadline = time.monotonic() + 120
    while jax_native.get_lib() is None and time.monotonic() < deadline:
        time.sleep(0.5)
        jax_native._tried = False  # get_lib looks (and builds) again
    return jax_native.get_lib()


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case", sorted(CSR_CASES))
def test_from_csr_arrays_equal_jax(case, dtype, jax_native_build):
    """f32 values compress to bf16 where lossless, indices to int8."""
    cj = CSR_CASES[case]()
    Aj = jax_bsell.BsellMatrix.from_csr(cj, JaxPolicy.from_names(dtype, "i32"))
    At = BsellMatrix.from_csr(to_port(cj), DTypePolicy.from_names(dtype),
                              device=CPU)
    assert_same_bsell(At, Aj, dtypes=False)
    assert At.lidx.dtype == torch.int8 and At.impl == "torch"
    assert At.padding_ratio == Aj.padding_ratio
    # the compression decision: bf16 exactly where the JAX build took it
    assert (At.vals.dtype == torch.bfloat16) == (
        np.asarray(Aj.vals).dtype.name == "bfloat16")


def test_bf16_compression_and_slice_padding_equal_jax():
    """Values bf16 cannot hold stay f32, in both packages; compress=False
    keeps f32; min_s_max pads zero slices as the JAX build does."""
    cj = wide_csr()
    cj_int = JaxCSR(row_ptr=cj.row_ptr, col=cj.col, val=np.round(cj.val * 8),
                    nr=cj.nr, nc=cj.nc)
    f32j, f32 = JaxPolicy.from_names("f32", "i32"), DTypePolicy.from_names(
        "f32")
    for c, want in ((cj, torch.float32), (cj_int, torch.bfloat16)):
        At = BsellMatrix.from_csr(to_port(c), f32, device=CPU)
        assert At.vals.dtype == want
        assert_same_bsell(At, jax_bsell.BsellMatrix.from_csr(c, f32j),
                          dtypes=False)
    assert BsellMatrix.from_csr(to_port(cj_int), f32, device=CPU,
                                compress=False).vals.dtype == torch.float32
    s_max = BsellMatrix.from_csr(to_port(cj), f32, device=CPU).s_max
    Aj = jax_bsell.BsellMatrix.from_csr(cj, f32j, min_s_max=s_max + 9)
    At = BsellMatrix.from_csr(to_port(cj), f32, device=CPU,
                              min_s_max=s_max + 9)
    assert At.s_max == s_max + 9
    assert_same_bsell(At, Aj, dtypes=False)


STENCIL_CASES = [((7, 6, 5), False), ((7, 6, 5), True), ((10, 9, 7), False),
                 ((10, 9, 7), True), ((20, 20, 12), False), ((1, 2, 3), False)]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("dims,use_7pt", STENCIL_CASES)
def test_from_stencil_equals_jax(dims, use_7pt, dtype):
    """The device build: vals, lidx, blocks, window and counts at several
    tiles with windows past 0 (20x20x12: wchunk up to 1), and the 1x2x3
    fallback to from_csr (its shifts alias)."""
    Aj, cj = jax_bsell.BsellMatrix.from_stencil(
        *dims, use_7pt=use_7pt, policy=JaxPolicy.from_names(dtype, "i32"))
    At, ct = BsellMatrix.from_stencil(*dims, use_7pt=use_7pt, device=CPU,
                                      policy=DTypePolicy.from_names(dtype))
    np.testing.assert_array_equal(ct, np.asarray(cj))
    assert_same_bsell(At, Aj, dtypes=dims != (1, 2, 3))
    if dims == (20, 20, 12):
        assert At.n_tiles == 5 and int(At.wchunk.max()) > 0


def test_from_stencil_matches_from_csr():
    """The device build and the host build give the same product."""
    csr = host.generate_stencil(20, 20, 12)
    x = np.random.default_rng(2).standard_normal(csr.nc)
    f64 = DTypePolicy.from_names("f64")
    As, counts = BsellMatrix.from_stencil(20, 20, 12, device=CPU, policy=f64)
    Ac = BsellMatrix.from_csr(csr, f64, device=CPU)
    np.testing.assert_array_equal(counts, csr.row_lengths)
    assert As.nnz == Ac.nnz == csr.nnz
    np.testing.assert_allclose(As.spmv(torch.from_numpy(x)).numpy(),
                               csr.spmv(x), rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("which", ["W", "2W-8", "2W", "4W", "refused"])
def test_with_window_equals_jax(which):
    """Forced chunk sizes re-anchor the block table as the JAX package's
    ``with_window`` does, the product unchanged; a W' below 2W - 8 or not
    a multiple of 8 is refused with its text."""
    cj = jax_generate(40, 20, 10)  # 8 tiles, W = 24
    Aj = jax_bsell.BsellMatrix.from_csr(cj, JaxPolicy.from_names("f64", "i32"))
    At = BsellMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f64"),
                              device=CPU)
    W = At.w_blocks
    assert W == 24
    if which == "refused":
        for w in (2 * W - 16, 2 * W + 4):
            with pytest.raises(ValueError) as ej:
                jax_bsell.with_window(Aj, w)
            with pytest.raises(ValueError) as et:
                bsell.with_window(At, w)
            assert str(et.value) == str(ej.value)
        return
    w = {"W": W, "2W-8": 2 * W - 8, "2W": 2 * W, "4W": 4 * W}[which]
    Bt, Bj = bsell.with_window(At, w), jax_bsell.with_window(Aj, w)
    assert (Bt is At) == (w == W)
    assert_same_bsell(Bt, Bj)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(At.nc))
    assert torch.equal(Bt.spmv(x), At.spmv(x))
    assert int(Bt.blocks.min()) >= 0 and int(Bt.blocks.max()) < 2 * w


def abs_bound(csr, x):
    return host.HostCSR(row_ptr=csr.row_ptr, col=csr.col,
                        val=np.abs(csr.val), nr=csr.nr,
                        nc=csr.nc).spmv(np.abs(x))


# the Pallas kernels in interpret mode take seconds a tile and slice: they
# run on one tile (test9) and on four with a window past chunk 0 (banded4t)
SPMV_CASES = [(case, "xla") for case in ("stencil7x6x5", "test9", "wide",
                                          "rcm32x8x8", "banded4t")] + [
    (case, impl) for case in ("test9", "banded4t")
    for impl in JAX_SPMV_IMPLS[1:]]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("case,impl", SPMV_CASES)
def test_plain_spmv_matches_jax(case, impl, dtype):
    """bsell_spmv_torch against the JAX package's XLA gather and its three
    Pallas kernels in interpret mode, on the same arrays; f32 with bf16
    values where lossless."""
    cj = CSR_CASES[case]()
    if dtype == "f32":
        cj = JaxCSR(row_ptr=cj.row_ptr, col=cj.col,
                    val=cj.val.astype(np.float32).astype(np.float64),
                    nr=cj.nr, nc=cj.nc)
    np_dt = np.float64 if dtype == "f64" else np.float32
    x = np.random.default_rng(3).standard_normal(cj.nc).astype(np_dt)
    Aj = jax_bsell.BsellMatrix.from_csr(cj, JaxPolicy.from_names(dtype, "i32"),
                                        impl=impl)
    At = BsellMatrix.from_csr(to_port(cj), DTypePolicy.from_names(dtype),
                              device=CPU)
    y_j = np.asarray(Aj.spmv(jnp.asarray(x)))
    y_t = At.spmv(torch.from_numpy(x)).numpy()
    assert y_t.dtype == np_dt
    bound = abs_bound(to_port(cj), x.astype(np.float64))
    err = np.abs(y_t.astype(np.float64) - y_j.astype(np.float64))
    assert err.max() <= TOL[dtype] * max(bound.max(), 1e-300)


def test_plain_spmv_sums_in_slice_order():
    """The plain version adds each slice's rounded product to the sum in
    stored order: one slice at a time by hand gives its bits."""
    A = BsellMatrix.from_csr(to_port(wide_csr()), DTypePolicy.from_names(
        "f32"), device=CPU)
    x2d = A.padded_x(torch.from_numpy(np.random.default_rng(8)
                                      .standard_normal(A.nc).astype(
                                          np.float32)), A.nc_pad // 128)
    acc = torch.zeros((A.n_tiles, 8, 128))
    xf = x2d.reshape(-1)
    for p in range(A.s_max):
        rows = A.blocks[:, p].long() + A.win_base[:, 0, :1].long()
        g = xf[rows[:, :, None] * 128 + A.lidx[:, p].long()]
        acc = acc + A.vals[:, p].float() * g
    assert torch.equal(bsell_spmv_torch(A.blocks, A.win_base, x2d, A.vals,
                                        A.lidx), acc)


def test_physical_bytes_equal_jax():
    cj = CSR_CASES["rcm32x8x8"]()
    Aj = jax_bsell.BsellMatrix.from_csr(cj, JaxPolicy.from_names("f32", "i32"))
    At = BsellMatrix.from_csr(to_port(cj), DTypePolicy.from_names("f32"),
                              device=CPU)
    assert physical_spmv_bytes(At, 4) == jax_physical_spmv_bytes(Aj, 4)


def test_impls_and_refusals():
    """Registry, impl names and the CPU: auto and torch run the plain
    version, the kernels and unknown names raise, and the wrappers raise on
    CPU tensors (no fallback)."""
    assert get_format("bsell") is BsellMatrix
    csr = host.generate_stencil(6, 5, 4)
    for impl in ("auto", "torch"):
        assert BsellMatrix.from_csr(csr, device=CPU, impl=impl).impl == "torch"
    for impl in ("kernel", "kernel_win2", "kernel_win"):
        with pytest.raises(ValueError, match="CUDA kernel"):
            BsellMatrix.from_csr(csr, device=CPU, impl=impl)
        with pytest.raises(ValueError, match="CUDA kernel"):
            BsellMatrix.from_stencil(6, 5, 4, device=CPU, impl=impl)
    with pytest.raises(ValueError, match="unknown bsell impl 'palas'"):
        BsellMatrix.from_csr(csr, device=CPU, impl="palas")
    A = BsellMatrix.from_csr(csr, device=CPU)
    x2d = A.padded_x(torch.ones(A.nc, dtype=torch.float64), A.nc_pad // 128)
    for fn, args in ((bsell_spmv, (A.blocks, A.win_base)),
                     (bsell_spmv_win2, (A.wchunk, A.blocks)),
                     (bsell_spmv_windowed, (A.wchunk, A.blocks))):
        kw = {} if fn is bsell_spmv else {"w_blocks": A.w_blocks}
        with pytest.raises(ValueError, match="one CUDA device"):
            fn(*args, x2d, A.vals, A.lidx, **kw)
        assert fn.launches == 0


# -- the CLI ------------------------------------------------------------------


def parse(out):
    res = {0: float(re.search(r"Initial Residual = (\S+)", out).group(1))}
    for j, v in re.findall(r"Iteration = (\d+) Residual = (\S+)", out):
        res[int(j)] = float(v)
    k = int(re.search(r"Solution performed (\d+) iterations", out).group(1))
    diff = re.search(r"Difference between computed and exact  = (\S+)", out)
    return res, k, diff and diff.group(1)


@pytest.mark.parametrize("argv", [
    ["-x", "16", "-y", "16", "-z", "16", "-i", "40"],
    ["-m", "tests/data/testMatrices/test2.mtx", "-i", "30"],
    ["-m", "tests/data/testMatrices/test9.mtx", "-i", "20"],
])
def test_cli_cg_matches_jax_cli(argv, capsys):
    """f64 -t cg --fmt bsell: the same iteration count, residual lines and
    difference line as the JAX CLI."""
    argv = argv + ["-t", "cg", "--fmt", "bsell", "--dtype", "f64"]
    assert jax_cli.main(argv) == 0
    out_j = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    res_j, k_j, diff_j = parse(out_j)
    res_t, k_t, diff_t = parse(out_t)
    assert "(format bsell)" in out_t and "bsell: " in out_t
    assert k_t == k_j and diff_t == diff_j and sorted(res_t) == sorted(res_j)
    above = [j for j in res_j if res_j[j] >= 1e-10 * res_j[0]]
    assert len(above) >= 3
    np.testing.assert_allclose([res_t[j] for j in above],
                               [res_j[j] for j in above], rtol=2e-6)
    line = r"SpMV streams (\S+) B/nnz physical"
    assert re.search(line, out_t).group(1) == re.search(line, out_j).group(1)


def test_cg_history_matches_jax():
    """The full f64 residual history through the library, 16^3 and 150
    iterations: rtol 1e-9 above 1e-10 of the initial residual (ROADMAP's
    parity floor), k equal."""
    from sparsebench_tpu.solvers.cg import init_vectors as jax_init

    cj = jax_generate(16, 16, 16)
    _x, b, _xe = jax_init(cj)
    rj = jax_solve_cg(jax_bsell.BsellMatrix.from_csr(
        cj, JaxPolicy.from_names("f64", "i32")), b, itermax=150,
        verbose=False)
    rt = solve_cg(BsellMatrix.from_csr(to_port(cj), DTypePolicy.from_names(
        "f64"), device=CPU), b, itermax=150, verbose=False)
    assert rt.iterations == rj.iterations
    hj, ht = np.asarray(rj.residual_history), rt.residual_history
    sel = ~np.isnan(hj) & (hj >= 1e-10 * hj[0])
    assert sel.sum() >= 20
    np.testing.assert_allclose(ht[sel], hj[sel], rtol=1e-9)
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), atol=1e-12)


def test_cli_spmv_runs(capsys):
    """-t spmv --fmt bsell runs the SpMV bench and its region table."""
    assert cli.main(["-t", "spmv", "--fmt", "bsell", "-x", "8", "-y", "8",
                     "-z", "8", "-i", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Test type: SPMVM" in out and "spMVM best per-iteration" in out


def test_cli_rcm_cuts_padding(tmp_path, capsys):
    """--rcm on a scrambled banded file cuts bsell's padding, as
    tests/test_cg.py:222 finds, and the solve runs."""
    scrambled = scrambled_and_restored(False)
    path = tmp_path / "scrambled.mtx"
    rows = np.repeat(np.arange(scrambled.nr), np.diff(scrambled.row_ptr))
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{scrambled.nr} {scrambled.nc} {scrambled.nnz}\n")
        np.savetxt(f, np.column_stack([rows + 1, scrambled.col + 1,
                                       scrambled.val]), fmt="%d %d %.1f")
    pad = {}
    for extra in ([], ["--rcm"]):
        assert cli.main(["-m", str(path), "-t", "cg", "--fmt", "bsell",
                         "-i", "10", "--device", "cpu", *extra]) == 0
        out = capsys.readouterr().out
        pad[bool(extra)] = float(re.search(r"padding (\S+),", out).group(1))
        assert "Solution performed 10 iterations" in out
    assert "RCM reordering applied" in out
    assert pad[True] < pad[False]


@pytest.mark.parametrize("argv,match", [
    (["--impl", "palas"], "unknown bsell impl 'palas'"),
    (["--impl", "kernel"], "CUDA kernel"),
    (["--impl", "kernel_win2"], "CUDA kernel"),
    (["--impl", "kernel_win"], "CUDA kernel"),
    (["-m", "generateRGL", "-x", "500"], "generateRGL builds on-device in "
     r"bslab layout; use --fmt auto\|bslab \(host formats would need a "
     r"disqualifyingly slow host build \+ upload at scale\)"),
])
def test_cli_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["-t", "cg", "--fmt", "bsell", "-x", "4", "-y", "4", "-z",
                  "4", "-i", "3", "--device", "cpu", *argv])


def test_cli_refusals_match_jax_text(capsys):
    """The JAX CLI refuses the same two requests with the same words."""
    with pytest.raises(ValueError, match="unknown bsell impl 'palas'"):
        jax_cli.main(["-t", "cg", "--fmt", "bsell", "-x", "4", "-y", "4",
                      "-z", "4", "-i", "3", "--impl", "palas"])
    with pytest.raises(SystemExit) as e:
        jax_cli.main(["-t", "cg", "--fmt", "bsell", "-m", "generateRGL",
                      "-x", "500"])
    with pytest.raises(SystemExit) as e_t:
        cli.main(["-t", "cg", "--fmt", "bsell", "-m", "generateRGL", "-x",
                  "500", "--device", "cpu"])
    assert str(e_t.value) == str(e.value)


@pytest.mark.parametrize("argv", [
    ["-t", "gmres"], ["-t", "cheb"], ["-t", "bicgstab"], ["-t", "minres"],
    ["-t", "cg", "--precond", "jacobi"], ["-t", "cg", "--precond", "cheb"],
    ["-t", "cg", "--nrhs", "3"], ["-t", "cg", "--refine"],
    ["-t", "cg", "--cg-variant", "cs"], ["-t", "cg", "--profile"],
])
def test_cli_solvers_run(argv, capsys):
    """Every -t, --precond, --nrhs and --refine the JAX CLI takes with
    --fmt bsell runs."""
    assert cli.main([*argv, "--fmt", "bsell", "-x", "8", "-y", "8", "-z",
                     "8", "-i", "12", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "(format bsell)" in out and "bsell: 1 tiles" in out
