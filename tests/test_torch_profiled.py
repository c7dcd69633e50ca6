"""Port parity: the profiled CG solve (``--profile``) of
sparsebench_tpu_torch against the JAX package's ``solve_cg_profiled``, on
the CPU, and the CLI's ``--profile`` and ``--banner``.

Both run the reference's iteration as a host loop (host-float rtrans and
pAp) on the same matrix (the JAX DiaMatrix carried over with
``from_jax_arrays``; JAX runs its ``xla`` SpMV) from the same numpy b.
Tolerances, f64: ``k`` equal; history entries at or above 1e-10 of the
initial residual agree to rtol 1e-9 (below it two summation orders are
rounding noise). The CLI's residual lines print 7 significant digits and
agree to rtol 2e-6 above the same floor.
"""

import re

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu import cli as jax_cli  # noqa: E402
from sparsebench_tpu.config import DTypePolicy as JaxPolicy  # noqa: E402
from sparsebench_tpu.formats.dia import DiaMatrix as JaxDia  # noqa: E402
from sparsebench_tpu.host import HostCSR, read_mm  # noqa: E402
from sparsebench_tpu.profiler import Profiler as JaxProfiler  # noqa: E402
from sparsebench_tpu.solvers import cg as jax_cg  # noqa: E402
from sparsebench_tpu.solvers.profiled import (  # noqa: E402
    solve_cg_profiled as jax_solve_cg_profiled,
)
from sparsebench_tpu_torch import cli  # noqa: E402
from sparsebench_tpu_torch.formats.dia import DiaMatrix  # noqa: E402
from sparsebench_tpu_torch.profiler import Profiler, Region  # noqa: E402
from sparsebench_tpu_torch.solvers.profiled import (  # noqa: E402
    solve_cg_profiled,
)

CPU = torch.device("cpu")
FLOOR, RTOL = 1e-10, 1e-9


def problem(case, data_dir):
    """(JAX matrix, port matrix, b) in f64 for a named case."""
    jp = JaxPolicy.from_names("f64", "i32")
    if case == "klein":
        csr = HostCSR.from_coo(read_mm(str(data_dir / "matrix_band_klein.mtx")))
        Aj = JaxDia.from_csr(csr, jp, impl="xla")
        b = np.random.default_rng(3).standard_normal(csr.nr)
    else:
        dims = {"16^3": (16, 16, 16), "10x9x7": (10, 9, 7)}[case]
        Aj, counts = JaxDia.from_stencil(*dims, policy=jp, impl="xla")
        _x, b, _xe = jax_cg.init_vectors(dtype=np.float64,
                                         row_lengths=np.asarray(counts))
    At = DiaMatrix.from_jax_arrays(
        np.asarray(Aj.data), Aj.offsets, Aj.nr, Aj.nc, Aj.nnz, Aj.nr_pad,
        Aj.start_row, Aj.total_nr, Aj.total_nnz, device=CPU, impl="torch")
    return Aj, At, b


@pytest.mark.parametrize("case", ["16^3", "10x9x7", "klein"])
def test_profiled_cg_f64_matches_jax(case, data_dir):
    Aj, At, b = problem(case, data_dir)
    rj = jax_solve_cg_profiled(Aj, b, JaxProfiler(), itermax=150,
                               verbose=False)
    prof = Profiler()
    rt = solve_cg_profiled(At, b, prof, itermax=150, verbose=False)
    assert rt.iterations == rj.iterations
    hj, ht = rj.residual_history, rt.residual_history
    assert ht.shape == hj.shape
    sel = hj >= FLOOR * hj[0]
    assert sel.sum() >= 5
    np.testing.assert_allclose(ht[sel], hj[sel], rtol=RTOL)
    for region in (Region.SPMVM, Region.DDOT, Region.WAXPBY):
        assert prof.times[region] > 0
    assert prof.times[Region.COMM] >= 0
    np.testing.assert_allclose(rt.x, np.asarray(rj.x), rtol=0, atol=1e-9)


def test_profiled_cg_hooks_and_widening():
    """``exchange`` sees every p before its product and ``allsum`` every
    dot; a matrix with more columns than rows takes widened vectors."""

    class Wide:  # [A | 0]: nc = nr + 3, the extra columns zero
        def __init__(self, A):
            self.A, self.nr, self.nc, self.device = A, A.nr, A.nr + 3, CPU

        def spmv(self, x):
            assert x.shape[0] == self.nc
            return self.A.spmv(x[: self.nr])

    _Aj, At, b = problem("10x9x7", None)
    calls = {"exchange": 0, "allsum": 0}

    def exchange(p):
        calls["exchange"] += 1
        return p

    def allsum(v):
        calls["allsum"] += 1
        return v

    r_wide = solve_cg_profiled(Wide(At), b, Profiler(), itermax=20,
                               exchange=exchange, allsum=allsum,
                               verbose=False)
    r_sq = solve_cg_profiled(At, b, Profiler(), itermax=20, verbose=False)
    assert calls["exchange"] == 20 and calls["allsum"] == 2 + 2 * 18
    np.testing.assert_array_equal(r_wide.residual_history,
                                  r_sq.residual_history)
    assert r_wide.x.shape == (At.nr,)


def parse_profile(out):
    res = [float(v) for v in re.findall(r"Residual = (\S+)", out)]
    k = int(re.search(r"Solution performed (\d+) iterations", out).group(1))
    labels = re.findall(r"^(\w+):\s+[\d.]+\s+[\d.]+\s+[\d.]+$", out, re.M)
    diff = re.search(r"Difference between computed and exact  = (\S+)", out)
    return res, k, labels, diff and diff.group(1)


@pytest.mark.parametrize("argv", [
    ["-t", "cg", "-x", "10", "-y", "9", "-z", "7", "-i", "40"],
    ["-t", "cg", "-x", "8", "-y", "8", "-z", "8", "-i", "30", "--fmt",
     "bslab"],
])
def test_cli_profile_matches_jax_cli(argv, capsys):
    argv = argv + ["--dtype", "f64", "--profile"]
    assert jax_cli.main(argv) == 0
    res_j, k_j, labels_j, diff_j = parse_profile(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    res_t, k_t, labels_t, diff_t = parse_profile(out)
    assert k_t == k_j and diff_t == diff_j
    assert labels_t == labels_j == ["waxpby", "spMVM", "ddot"]
    assert "Function   Rate(MB/s)  Rate(MFlop/s)  Walltime(s)" in out
    assert len(res_t) == len(res_j)
    sel = np.asarray(res_j) >= FLOOR * res_j[0]
    np.testing.assert_allclose(np.asarray(res_t)[sel], np.asarray(res_j)[sel],
                               rtol=2e-6)
    assert "Solve aggregate (fused)" not in out  # the table replaces it
    spmvm = re.search(r"^spMVM:\s+([\d.]+)", out, re.M)
    assert float(spmvm.group(1)) > 0


@pytest.mark.parametrize("bench", ["gmres", "cheb", "bicgstab", "minres"])
def test_cli_profile_warns_like_jax(bench, capsys):
    argv = ["-t", bench, "-x", "4", "-y", "4", "-z", "4", "-i", "3",
            "--profile"]
    assert jax_cli.main(argv) == 0
    err_j = capsys.readouterr().err
    assert cli.main(argv + ["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    warn = lambda e: [ln for ln in e.splitlines()  # noqa: E731
                      if ln.startswith("warning:")]
    assert warn(captured.err) == warn(err_j) == [
        f"warning: --profile has no effect with -t {bench}"]
    assert "Rate(MB/s)" not in captured.out


def test_cli_profile_spmv_prints_the_table_once(capsys):
    argv = ["-t", "spmv", "-x", "5", "-y", "5", "-z", "5", "-i", "5",
            "--profile", "--device", "cpu"]
    assert cli.main(argv) == 0
    captured = capsys.readouterr()
    assert captured.out.count("Rate(MB/s)") == 1 and not captured.err


@pytest.mark.parametrize("argv", [
    ["--profile", "--refine"],
    ["--profile", "--nrhs", "2"],
    ["--profile", "--precond", "jacobi"],
    ["--profile", "--precond", "cheb"],
    ["--profile", "--cg-variant", "cs"],
    ["--profile", "--cg-variant", "pipe"],
])
def test_cli_profile_refusals_match_jax(argv, tmp_path, monkeypatch, capsys):
    """Each combination the JAX CLI refuses with --profile exits with its
    text, before the port builds the matrix."""
    monkeypatch.chdir(tmp_path)
    argv = argv + ["-x", "4", "-y", "4", "-z", "4", "-i", "3"]
    with pytest.raises(SystemExit) as ej:
        jax_cli.main(argv)
    capsys.readouterr()
    with pytest.raises(SystemExit) as et:
        cli.main(argv + ["--device", "cpu"])
    assert str(et.value) == str(ej.value) and str(et.value)
    assert "Setup took" not in capsys.readouterr().out


def test_cli_banner_on_the_cpu(capsys):
    argv = ["-t", "cg", "-x", "4", "-y", "4", "-z", "4", "-i", "3",
            "--banner", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    i = next(j for j, ln in enumerate(lines) if ln.startswith("Process "))
    assert lines[i - 1].startswith("sparsebench_tpu_torch ")
    assert re.match(r"Process \d+ on host \S+:$", lines[i])
    assert "torch " + torch.__version__ in lines[i + 1]
    assert lines[i + 2] == "Parameters"
    assert cli.main(argv[:-3] + ["--device", "cpu"]) == 0
    assert "Process " not in capsys.readouterr().out


@pytest.mark.parametrize("name,ending", [
    ("matrix.mtx", ".bmx"), ("matrix.mtx", "bmx"), ("dir.v2/m", ".bmx"),
    ("noext", "bmx"), ("a.b.c", ".d"),
])
def test_utils_match_jax(name, ending):
    """The reference's util and timing helpers, as the JAX package has
    them; on the CPU there are no device memory counters."""
    from sparsebench_tpu import utils as jax_utils
    from sparsebench_tpu_torch import utils

    assert (utils.change_file_ending(name, ending)
            == jax_utils.change_file_ending(name, ending))
    assert utils.get_timer_resolution() == jax_utils.get_timer_resolution()
    t0 = utils.get_timestamp()
    assert utils.elapsed_seconds(lambda: None, "cpu") >= 0
    assert utils.get_timestamp() >= t0
    assert utils.device_memory_stats("cpu") is None
