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
    diff = re.search(r"Difference between computed and exact  = (\S+)",
                     out).group(1)
    return res, k, diff


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
    (["--fmt", "sell"], "item 7"),
    (["--fmt", "bslab"], "item 7"),
    (["--fmt", "bsell"], "item 10"),
    (["-t", "gmres"], "item 9"),
    (["--cg-variant", "sstep"], "item 9"),
])
def test_unported_flags_name_their_roadmap_item(argv, where):
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {where}"):
        cli.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("text,where", [
    ("shards 4\n", "item 11"),
    ("filename generateRGL\n", "item 8"),
    ("bench cheb\n", "item 9"),
])
def test_unported_par_keys_name_their_roadmap_item(text, where, tmp_path):
    par = tmp_path / "t.par"
    par.write_text(text)
    with pytest.raises(SystemExit, match=f"ROADMAP.md Queue 1 {where}"):
        cli.main(["-f", str(par), "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--precond", "jacobi"], ["--shards", "4"], ["--profile"],
    ["--checkpoint", "ck.npz"], ["--nrhs", "8"], ["--rcm"], ["--seed", "3"],
    ["-c", "m.mtx"],
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


def test_dia_unsuitable_names_the_bslab_item(tmp_path):
    """A matrix with more than 64 diagonals exits and names the bslab item
    (the JAX CLI falls back to bslab there, which is not ported)."""
    n = 100
    rows = np.arange(n)
    cols = np.random.default_rng(0).permutation(n)  # ~n distinct offsets
    entries = [f"{i + 1} {i + 1} 4.0" for i in rows]
    entries += [f"{i + 1} {c + 1} 1.0" for i, c in zip(rows, cols) if c != i]
    lines = ["%%MatrixMarket matrix coordinate real general",
             f"{n} {n} {len(entries)}", *entries]
    path = tmp_path / "scatter.mtx"
    path.write_text("\n".join(lines) + "\n")
    with pytest.raises(SystemExit, match="ROADMAP.md Queue 1 item 7"):
        cli.main(["-m", str(path), "--device", "cpu", "-i", "3"])
