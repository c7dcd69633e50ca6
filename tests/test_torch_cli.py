"""Port parity: the sparsebench_tpu_torch CLI against the JAX CLI, on the CPU
(``--device cpu``), plus its refusals.

The two CLIs run the same command in-process; the residual lines, the
iteration count and the difference line are parsed and compared. Residuals
print with 7 significant digits, so lines above the f64 noise floor (1e-10
of the initial residual) agree to rtol 2e-6.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)

from sparsebench_tpu import cli as jax_cli  # noqa: E402
from sparsebench_tpu_torch import cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(out):
    res = {}
    m = re.search(r"Initial Residual = (\S+)", out)
    res[0] = float(m.group(1))
    for j, v in re.findall(r"Iteration = (\d+) Residual = (\S+)", out):
        res[int(j)] = float(v)
    k = int(re.search(r"Solution performed (\d+) iterations", out).group(1))
    diff = re.search(r"Difference between computed and exact  = (\S+)", out)
    return res, k, diff and diff.group(1)


def test_cli_cg_matches_jax_cli(capsys):
    argv = ["-t", "cg", "-x", "12", "-y", "12", "-z", "12", "-i", "40",
            "--dtype", "f64"]
    assert jax_cli.main(argv) == 0
    res_j, k_j, diff_j = parse(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    res_t, k_t, diff_t = parse(capsys.readouterr().out)
    assert k_t == k_j == 40
    assert diff_t == diff_j
    assert sorted(res_t) == sorted(res_j)
    above = [j for j in res_j if res_j[j] >= 1e-10 * res_j[0]]
    assert len(above) >= 5
    np.testing.assert_allclose([res_t[j] for j in above],
                               [res_j[j] for j in above], rtol=2e-6)


@pytest.mark.parametrize("argv", [
    ["-t", "cg", "-x", "6", "-y", "6", "-z", "6", "-i", "15"],
    ["-t", "cg", "-x", "5", "-y", "4", "-z", "3", "-i", "10", "--dtype",
     "bf16"],
    ["-x", "4", "-y", "4", "-z", "4", "-i", "8", "--impl", "torch"],
])
def test_cli_cg_runs(argv, capsys):
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Test type: CG" in out and "Initial Residual" in out
    assert "Difference between computed and exact" in out
    assert "| cpu | spmv torch" in out


def test_cli_spmv_runs(capsys):
    argv = ["-t", "spmv", "-x", "5", "-y", "5", "-z", "5", "-i", "5",
            "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Test type: SPMVM" in out
    assert "spMVM best per-iteration time" in out
    assert "Rate(MB/s)" in out and "spMVM" in out


def test_cli_matrix_file_and_par_file(tmp_path, data_dir, capsys):
    assert cli.main(["-m", str(data_dir / "matrix_band_klein.mtx"), "-i",
                     "10", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Read MTX matrix" in out and "Solution performed" in out
    assert "Difference between" not in out  # no exact solution for a file
    par = tmp_path / "t.par"
    par.write_text("filename generate7P # 7-point\nnx 5\nny 4\nnz 3\n"
                   "itermax 9\n")
    assert cli.main(["-f", str(par), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Max iterations: 9" in out and "Difference between" in out


def test_cli_bmx_file_matches_mtx(tmp_path, data_dir, capsys):
    """-m reads a .bmx file written by the JAX package; same solve as the
    .mtx it came from."""
    from sparsebench_tpu.host import HostCSR, read_mm
    from sparsebench_tpu.host.binfile import write_bmx

    mtx = data_dir / "matrix_band_klein.mtx"
    bmx = tmp_path / "klein.bmx"
    write_bmx(HostCSR.from_coo(read_mm(str(mtx))), str(bmx))
    outs = []
    for path in (mtx, bmx):
        assert cli.main(["-m", str(path), "-i", "6", "--dtype", "f64",
                         "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        outs.append(re.findall(r"Residual = \S+", out))
    assert "Read BMX matrix" in out
    assert outs[0] == outs[1] and len(outs[0]) >= 2


def test_cli_trace_writes_torch_profile(tmp_path, capsys):
    logdir = tmp_path / "trace"
    assert cli.main(["-t", "spmv", "-x", "4", "-y", "4", "-z", "4", "-i",
                     "3", "--device", "cpu", "--trace", str(logdir)]) == 0
    assert (logdir / "trace.json").stat().st_size > 0


def test_cli_imports_no_jax():
    """The port and its CLI import neither jax nor the JAX package (run in
    a fresh interpreter)."""
    code = (
        "import sys\n"
        "from sparsebench_tpu_torch.cli import main\n"
        "assert main(['-t', 'cg', '-x', '8', '-y', '8', '-z', '8', '-i', "
        "'10', '--device', 'cpu']) == 0\n"
        "assert main(['-t', 'spmv', '-x', '8', '-y', '8', '-z', '8', '-i', "
        "'3', '--device', 'cpu']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sparsebench_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_no_silent_cpu_without_cuda(monkeypatch):
    """Without CUDA, the default device and --impl kernel both refuse to
    run instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        cli.main(["-t", "cg", "-x", "4", "-y", "4", "-z", "4", "-i", "3"])
    with pytest.raises(SystemExit, match="kernel"):
        cli.main(["-t", "cg", "-x", "4", "-y", "4", "-z", "4", "-i", "3",
                  "--device", "cpu", "--impl", "kernel"])


@pytest.mark.parametrize("argv,where", [
    (["--fmt", "bsell"], "item 10"),
    (["--fmt", "bsell", "-t", "gmres"], "item 10"),
])
def test_unported_flags_name_their_roadmap_item(argv, where, capsys):
    """--fmt bsell was refused, naming ROADMAP.md Queue 1 ``where``, until
    that item ported it: the request now runs."""
    assert where == "item 10"
    assert cli.main(argv + ["-x", "6", "-y", "6", "-z", "6", "-i", "8",
                            "--device", "cpu"]) == 0
    assert "(format bsell)" in capsys.readouterr().out


@pytest.mark.parametrize("text,where", [
    ("shards 4\n", "item 11"),
    ("fmt bsell\n", "item 10"),
    ("bench cheb\nshards 2\n", "item 11"),
])
def test_unported_par_keys_name_their_roadmap_item(text, where, tmp_path,
                                                   capsys):
    """A .par file's shards exits naming its ROADMAP.md item (11); its
    ``fmt bsell``, refused until item 10 ported it, now runs."""
    par = tmp_path / "t.par"
    par.write_text(text + "nx 6\nny 6\nnz 6\nitermax 8\n")
    if where == "item 10":
        assert cli.main(["-f", str(par), "--device", "cpu"]) == 0
        assert "(format bsell)" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {where}"):
        cli.main(["-f", str(par), "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--shards", "4"], ["--shards", "1"], ["--exchange", "auto"],
    ["--overlap"], ["--exchange", "ppermute"], ["-c", "m.mtx"],
])
def test_jax_only_flags_are_rejected(argv, capsys):
    """The JAX CLI's flags that are not ported are absent: argparse exits
    with its usage error instead of ignoring them."""
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_unported_defaults_are_accepted(capsys):
    argv = ["-x", "4", "-y", "4", "-z", "4", "-i", "3", "--device", "cpu",
            "--cg-variant", "standard", "--fmt", "dia"]
    assert cli.main(argv) == 0


def scattered_mtx(path, n=100, seed=0):
    """A matrix with about n distinct diagonals: DIA refuses it."""
    rows = np.arange(n)
    cols = np.random.default_rng(seed).permutation(n)
    entries = [f"{i + 1} {i + 1} 4.0" for i in rows]
    entries += [f"{i + 1} {c + 1} 1.0" for i, c in zip(rows, cols) if c != i]
    lines = ["%%MatrixMarket matrix coordinate real general",
             f"{n} {n} {len(entries)}", *entries]
    path.write_text("\n".join(lines) + "\n")
    return path


def test_dia_unsuitable_names_the_bslab_item(tmp_path, capsys):
    """A matrix with more than 64 diagonals: --fmt auto falls back to
    bslab, as the JAX CLI does, and --fmt dia exits naming the limit."""
    path = scattered_mtx(tmp_path / "scatter.mtx")
    assert cli.main(["-m", str(path), "--device", "cpu", "-i", "3"]) == 0
    out = capsys.readouterr().out
    assert "(format bslab)" in out and "Solution performed" in out
    with pytest.raises(SystemExit, match="max_diags"):
        cli.main(["-m", str(path), "--device", "cpu", "-i", "3", "--fmt",
                  "dia"])


def run_both(argv, capsys):
    """The JAX CLI and the port's (--device cpu) on one command: their
    parsed residuals, k and difference line, and the port's output."""
    assert jax_cli.main(argv) == 0
    out_j = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    return parse(out_j), parse(out_t), out_j, out_t


def assert_same_solve(res_j, res_t, k_j, k_t):
    """Same k and printed residuals; printed with 7 significant digits,
    lines above the f64 noise floor agree to rtol 2e-6."""
    assert k_t == k_j
    assert sorted(res_t) == sorted(res_j)
    above = [j for j in res_j if res_j[j] >= 1e-10 * res_j[0]]
    np.testing.assert_allclose([res_t[j] for j in above],
                               [res_j[j] for j in above], rtol=2e-6)


@pytest.mark.parametrize("fmt", ["bslab", "sell", "ell", "crs", "ccrs"])
def test_cli_general_formats_match_jax_cli(fmt, capsys):
    argv = ["-t", "cg", "-x", "12", "-y", "12", "-z", "12", "-i", "40",
            "--dtype", "f64", "--fmt", fmt]
    (res_j, k_j, diff_j), (res_t, k_t, diff_t), out_j, out_t = run_both(
        argv, capsys)
    assert_same_solve(res_j, res_t, k_j, k_t)
    assert k_t == 40 and diff_t == diff_j
    want = "bslab" if fmt == "sell" else fmt
    assert f"(format {want})" in out_t and f"(format {want})" in out_j
    if fmt == "sell":
        assert "bridged to the bslab device build" in out_t


@pytest.mark.parametrize("fmt", ["bslab", "sell", "ell", "crs", "ccrs"])
def test_general_format_cg_history_matches_jax(fmt):
    """The solver-level history behind the CLI line (ROADMAP's parity rule):
    f64 CG on the 12^3 stencil through each format of both packages, k
    equal, the history to rtol 1e-9 where normr >= 1e-10 normr0. SELL runs
    its permuted gather path in both."""
    from sparsebench_tpu.formats import from_csr as jax_from_csr
    from sparsebench_tpu.host import generate_stencil as jax_generate
    from sparsebench_tpu.solvers.cg import init_vectors as jax_init
    from sparsebench_tpu.solvers.cg import solve_cg as jax_solve
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats import from_csr
    from sparsebench_tpu_torch.host import generate_stencil
    from sparsebench_tpu_torch.solvers.cg import solve_cg

    opts = {"bridge": False} if fmt == "sell" else {}
    cj = jax_generate(12, 12, 12)
    _x, b, _xe = jax_init(cj, dtype=np.float64)
    rj = jax_solve(jax_from_csr(fmt, cj, **opts), b, itermax=40,
                   verbose=False)
    A = from_csr(fmt, generate_stencil(12, 12, 12),
                 DTypePolicy.from_names("f64"), device="cpu")
    rt = solve_cg(A, b, itermax=40, verbose=False)
    assert rt.iterations == rj.iterations == 40
    h_j, h_t = rj.residual_history, rt.residual_history
    sel = h_j >= 1e-10 * h_j[0]
    assert sel.sum() >= 10
    np.testing.assert_allclose(h_t[sel], h_j[sel], rtol=1e-9)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=1e-10)


def test_cli_auto_falls_back_to_bslab_like_jax(tmp_path, capsys):
    path = scattered_mtx(tmp_path / "scatter.mtx", n=300, seed=3)
    argv = ["-t", "cg", "-m", str(path), "-i", "20", "--dtype", "f64"]
    assert jax_cli.main(argv) == 0
    out_j = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert "(format bslab)" in out_j and "(format bslab)" in out_t
    (res_j, k_j, _), (res_t, k_t, _) = parse(out_j), parse(out_t)
    assert_same_solve(res_j, res_t, k_j, k_t)


@pytest.mark.parametrize("fmt", ["auto", "bslab", "crs"])
def test_cli_rcm_matches_jax(fmt, tmp_path, capsys):
    path = scattered_mtx(tmp_path / "scatter.mtx", n=200, seed=5)
    argv = ["-t", "cg", "-m", str(path), "-i", "15", "--dtype", "f64",
            "--rcm", "--fmt", fmt]
    assert jax_cli.main(argv) == 0
    out_j = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    assert "RCM reordering applied (200 rows)" in out_t
    (res_j, k_j, _), (res_t, k_t, _) = parse(out_j), parse(out_t)
    assert_same_solve(res_j, res_t, k_j, k_t)
    assert (re.search(r"\(format (\w+)\)", out_t).group(1)
            == re.search(r"\(format (\w+)\)", out_j).group(1))


@pytest.mark.parametrize("bench", ["cg", "spmv"])
def test_cli_generate_rgl_matches_jax(bench, capsys):
    argv = ["-t", bench, "-m", "generateRGL", "-x", "3000", "-y", "1", "-z",
            "1", "--band", "96", "-i", "3", "--dtype", "f64"]
    assert jax_cli.main(argv) == 0
    out_j = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    rgl = re.compile(r"RGL: n=\d+ band=\d+ deg~\S+ seed=\d+ nnz=\d+")
    assert rgl.search(out_t).group(0) == rgl.search(out_j).group(0)
    if bench == "cg":
        assert parse(out_t)[1:] == parse(out_j)[1:]
    else:
        assert "spMVM best per-iteration time" in out_t
    with pytest.raises(SystemExit, match="bslab"):
        cli.main(argv + ["--device", "cpu", "--fmt", "crs"])


def test_cli_par_file_drives_generate_rgl(tmp_path, capsys):
    par = tmp_path / "rgl.par"
    par.write_text("filename generateRGL\nnx 2000\nny 1\nnz 1\nband 64\n"
                   "deg 6\nseed 3\nitermax 5\n")
    assert cli.main(["-f", str(par), "--device", "cpu", "--sub", "8"]) == 0
    out = capsys.readouterr().out
    assert "RGL: n=2000 band=64 deg~6.0 seed=3" in out
    assert "bslab: sub 8" in out and "Difference between" in out


def test_cli_impl_kernel_win_is_bslab_only(capsys):
    with pytest.raises(SystemExit, match="CUDA kernel"):
        cli.main(["-x", "4", "-y", "4", "-z", "4", "-i", "3", "--device",
                  "cpu", "--impl", "kernel_win", "--fmt", "bslab"])


# -- the solver family (Queue 1 item 9) ---------------------------------------

SMALL = ["-x", "10", "-y", "9", "-z", "7", "-i", "40", "--dtype", "f64"]
# the numbers each bench prints, by line; the last group is the value
LINES = {
    "cg": r"(?:Initial Residual|Iteration = \d+ Residual) = (\S+)",
    "gmres": r"GMRES cycle \d+: iterations = \d+ Residual = (\S+)",
    "refine": r"(?:Initial Residual|Refinement sweep = \d+ Residual) = (\S+)",
    "checkpoint": r"checkpoint @ iteration \d+ residual (\S+) ->",
    "cheb": r"\(final residual (\S+)\)",
}
COUNTS = r"(Solution performed \d+ (?:iterations|sweeps / \d+ low-precision " \
    r"iterations)|GMRES cycle \d+: iterations = \d+|Chebyshev performed \d+ " \
    r"iterations|Chebyshev bounds: lmin = \S+ lmax = \S+|\[cg-multi\] .*|" \
    r"Blocked CG: .*|Preconditioner: .*|Refinement: .*|Resuming .*)"


def values(out, kind):
    return [float(v) for v in re.findall(LINES[kind], out)]


def diff_line(out):
    m = re.search(r"Difference between computed and exact  = (\S+)", out)
    return m and m.group(1)


@pytest.mark.parametrize("argv,kind,floor,rtol", [
    (["-t", "cg", "--nrhs", "4"], "cg", 1e-10, 2e-6),
    (["-t", "gmres", "--restart", "10"], "gmres", 1e-8, 2e-6),
    (["-t", "gmres", "--restart", "10", "--orth", "cgs2"], "gmres", 1e-8,
     2e-6),
    (["-t", "gmres", "--restart", "8", "--precond", "jacobi"], "gmres", 1e-8,
     2e-6),
    (["-t", "cheb"], "cheb", 1e-10, 2e-6),
    (["-t", "cheb", "--precond", "jacobi"], "cheb", 1e-10, 2e-6),
    (["-t", "bicgstab"], "cg", 1e-6, 2e-6),
    (["-t", "bicgstab", "--precond", "cheb"], "cg", 1e-6, 2e-6),
    (["-t", "minres"], "cg", 1e-10, 2e-6),
    (["-t", "minres", "--precond", "jacobi"], "cg", 1e-10, 2e-6),
    (["-t", "cg", "--precond", "jacobi"], "cg", 1e-10, 2e-6),
    (["-t", "cg", "--precond", "cheb", "--precond-degree", "2"], "cg",
     1e-10, 2e-6),
    (["-t", "cg", "--precond", "cheb-jacobi"], "cg", 1e-10, 2e-6),
    (["-t", "cg", "--cg-variant", "cs", "--precond", "jacobi"], "cg", 1e-10,
     2e-6),
    (["-t", "cg", "--cg-variant", "sstep"], "cg", 1e-6, 2e-6),
    (["-t", "cg", "--cg-variant", "sstep", "--sstep", "2"], "cg", 1e-6,
     2e-6),
    (["-t", "cg", "--cg-variant", "pipe"], "cg", 1e-8, 2e-6),
    (["-t", "cg", "--cg-variant", "pipe", "--precond", "cheb"], "cg", 1e-8,
     2e-6),
    (["-t", "cg", "--refine"], "refine", 1e-4, 1e-4),
    (["-t", "cg", "--refine", "--refine-sweeps", "3"], "refine", 1e-4, 1e-4),
])
def test_cli_solver_family_matches_jax_cli(argv, kind, floor, rtol, capsys):
    """Each new flag's output lines against the JAX CLI's: the same count
    and summary lines, the printed residuals (7 significant digits) to
    rtol 2e-6 above the method's noise floor (tests/test_torch_solvers.py
    has the floors; --refine's inner solves are f32, so its sweeps follow
    the f32 rule), and the same Difference line."""
    argv = argv + SMALL
    assert jax_cli.main(argv) == 0
    out_j = capsys.readouterr().out
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out_t = capsys.readouterr().out
    vj, vt = values(out_j, kind), values(out_t, kind)
    assert len(vt) == len(vj) >= (1 if kind == "cheb" else 2)
    # the initial residual: ||b|| for GMRES (b = 1), ||b - A 0|| otherwise
    ref = {"gmres": np.sqrt(10 * 9 * 7), "cheb": 223.9643}.get(kind, vj[0])
    above = [i for i, v in enumerate(vj) if v >= floor * ref]
    assert above
    np.testing.assert_allclose([vt[i] for i in above],
                               [vj[i] for i in above], rtol=rtol)
    # the summary lines; the bounds are compared in their own test, and
    # --refine's total of f32 inner iterations may differ by one a sweep
    # (an inner eps exit lands in f32 noise), its sweep count may not
    def summary(out):
        lines = [re.sub(r"(lmin|lmax) = \S+", r"\1", c)
                 for c in re.findall(COUNTS, out)]
        return [re.sub(r"/ \d+ low", "/ N low", c) for c in lines]

    assert summary(out_t) == summary(out_j) != []
    inner = r"sweeps / (\d+) low"
    if kind == "refine":
        nj, nt = (int(re.search(inner, o).group(1)) for o in (out_j, out_t))
        assert abs(nt - nj) <= len(vj)
    assert diff_line(out_t) == diff_line(out_j)


def test_cli_chebyshev_bounds_lines_match_jax(capsys):
    """The printed bounds (4 or 5 significant digits) are equal."""
    for argv in (["-t", "cheb"], ["-t", "cg", "--precond", "cheb-jacobi"]):
        assert jax_cli.main(argv + SMALL) == 0
        out_j = capsys.readouterr().out
        assert cli.main(argv + SMALL + ["--device", "cpu"]) == 0
        out_t = capsys.readouterr().out
        pat = r"(Chebyshev bounds: .*|Preconditioner: Chebyshev.*)"
        assert re.findall(pat, out_t) == re.findall(pat, out_j) != []


def test_cli_checkpoint_matches_jax_cli(tmp_path, capsys):
    """--checkpoint: the same segment lines (residuals above the floor to
    the printed digits), a resumed run continues from the file, and the
    Difference line of the JAX CLI."""
    outs = []
    for name, main, extra in (("j", jax_cli.main, []),
                              ("t", cli.main, ["--device", "cpu"])):
        path = str(tmp_path / f"{name}.npz")
        argv = ["-t", "cg", "--checkpoint", path, "--checkpoint-every", "15",
                "-x", "10", "-y", "9", "-z", "7", "--dtype", "f64"]
        runs = []
        for itermax in ("40", "60"):
            assert main(argv + ["-i", itermax] + extra) == 0
            runs.append(capsys.readouterr().out)
        outs.append(runs)
    (j1, j2), (t1, t2) = outs
    for oj, ot in ((j1, t1), (j2, t2)):
        vj, vt = values(oj, "checkpoint"), values(ot, "checkpoint")
        assert len(vt) == len(vj) >= 1
        sel = [i for i, v in enumerate(vj) if v >= 1e-10 * 224.0]
        np.testing.assert_allclose([vt[i] for i in sel], [vj[i] for i in sel],
                                   rtol=2e-6)
        assert diff_line(ot) == diff_line(oj)
    assert "at iteration 40" in t2 and "at iteration 40" in j2
    assert "checkpoint @ iteration 60" in t2


def test_cli_nrhs_lines(capsys):
    argv = ["-t", "cg", "--nrhs", "3", *SMALL]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Blocked CG: 3 right-hand sides" in out
    assert "[cg-multi] 3 right-hand sides, per-column iterations 40..40" in out
    assert "Difference between computed and exact  = 0.000000" in out


WARNINGS = [
    (["-t", "spmv", "--orth", "cgs2", "--restart", "5"],
     ["--orth has no effect with -t spmv",
      "--restart has no effect with -t spmv"]),
    (["-t", "gmres", "--cg-variant", "cs", "--nrhs", "2", "--checkpoint",
      "ck.npz"],
     ["--cg-variant has no effect with -t gmres",
      "--nrhs has no effect with -t gmres",
      "--checkpoint has no effect with -t gmres"]),
    (["-t", "minres", "--refine"], ["--refine has no effect with -t minres"]),
    (["-t", "cg", "--sstep", "3", "--checkpoint-every", "5",
      "--precond-degree", "5", "--refine-sweeps", "3"],
     ["--sstep has no effect without", "--checkpoint-every has no effect",
      "--precond-degree has no effect", "--refine-sweeps has no effect"]),
]


@pytest.mark.parametrize("argv,texts", WARNINGS)
def test_cli_warnings_match_jax(argv, texts, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = argv + ["-x", "4", "-y", "4", "-z", "4", "-i", "3"]
    assert jax_cli.main(argv) == 0
    err_j = capsys.readouterr().err
    assert cli.main(argv + ["--device", "cpu"]) == 0
    err_t = capsys.readouterr().err
    warn = lambda e: [ln for ln in e.splitlines()  # noqa: E731
                      if ln.startswith("warning:")]
    assert warn(err_t) == warn(err_j)
    for t in texts:
        assert t in err_t


REFUSALS = [
    ["--cg-variant", "sstep", "--sstep", "0"],
    ["-t", "gmres", "--restart", "0"],
    ["--refine", "--precond", "jacobi"],
    ["--refine", "--cg-variant", "cs"],
    ["--nrhs", "0"],
    ["--nrhs", "2", "--cg-variant", "pipe"],
    ["--nrhs", "2", "--precond", "jacobi"],
    ["--nrhs", "2", "--fmt", "stencil"],
    ["--nrhs", "2", "--refine"],
    ["-t", "cheb", "--precond", "cheb"],
    ["-t", "minres", "--precond", "cheb-jacobi"],
    ["--precond", "cheb", "--cg-variant", "sstep"],
    ["--precond", "jacobi", "--checkpoint", "ck.npz"],
    ["--cg-variant", "pipe", "--checkpoint", "ck.npz"],
    ["-m", "generateRGL", "-x", "3000", "-y", "1", "-z", "1", "--band", "64",
     "--precond", "jacobi"],
]


@pytest.mark.parametrize("argv", REFUSALS)
def test_cli_refusals_match_jax(argv, tmp_path, monkeypatch):
    """The combinations the JAX CLI refuses exit with its text."""
    monkeypatch.chdir(tmp_path)
    argv = argv + ["-x", "4", "-y", "4", "-z", "4", "-i", "3"] \
        if "generateRGL" not in argv else argv + ["-i", "3"]
    with pytest.raises(SystemExit) as ej:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as et:
        cli.main(argv + ["--device", "cpu"])
    assert str(et.value) == str(ej.value) and str(et.value)


@pytest.mark.parametrize("argv", [
    ["--precond", "cheb", "--cg-variant", "sstep"],
    ["--precond", "cheb", "--checkpoint", "ck.npz"],
    ["--cg-variant", "pipe", "--checkpoint", "ck.npz"],
])
def test_cli_refuses_before_the_build(argv, capsys, tmp_path, monkeypatch):
    """Every refused combination exits before the matrix is built or a
    Chebyshev bound is estimated."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        cli.main(argv + ["-x", "4", "-y", "4", "-z", "4", "-i", "3",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Setup took" not in out and "Preconditioner" not in out
    assert not (tmp_path / "ck.npz").exists()


def test_cli_solver_family_imports_no_jax():
    """The new benches and flags import neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "from sparsebench_tpu_torch.cli import main\n"
        "small = ['-x', '6', '-y', '6', '-z', '6', '-i', '8', '--device', "
        "'cpu']\n"
        "for a in (['-t', 'gmres'], ['-t', 'cheb'], ['-t', 'bicgstab'], "
        "['-t', 'minres'], ['--nrhs', '2'], ['--precond', 'cheb'], "
        "['--cg-variant', 'sstep'], ['--cg-variant', 'pipe'], "
        "['--refine']):\n"
        "    assert main(a + small) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sparsebench_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
