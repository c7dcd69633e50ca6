"""run.py as the driver runs it, and the rest of a run on the CPU at a
small grid (past the look for a card): a sound run is correct and writes
no device metric; the control (the program's bf16 vectors) and each fault
planted in the timed path under the harness come out not correct."""

import shutil
import subprocess
import sys

import pytest
import torch

import run
from harness.spec import ROOT, Spec
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.solvers import cg as cg_mod
from sparsebench_tpu_torch.solvers import cg_multi as multi_mod

# a small grid, and few enough iterations that no f32 residual underflows
SMALL = {"nx": 20, "ny": 19, "nz": 18, "itermax": 60}
CELLS = [w["name"] for w in Spec().bench["workloads"]]
ARGS = ["--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"]


def cpu_run(cell: str, control: bool = False) -> dict:
    spec = Spec()
    cfg = dict(spec.config(spec.cell(cell)["config"]), **SMALL)
    return run.run(spec, cell, 2**31 + 17, 0.3, False, torch.device("cpu"),
                   control=control, config=cfg)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: run.py would measure")
    p = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch" / "run.py"),
         "--workload", "hpcg27-200.cg", *ARGS],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "no result" in p.stderr


def test_no_program_no_result(tmp_path):
    """A directory with BENCHMARK.json and bench_torch/ alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload",
         "hpcg27-200.cg", *ARGS],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_writes_no_device_number(cell):
    r = cpu_run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    # a run on the CPU writes no metric and no device figure
    assert r["metrics"] == {} and r["device"] == {}
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = cpu_run(cell, control=True)
    assert not r["correct"], r["checks"]


def _bump(t: torch.Tensor) -> torch.Tensor:
    """t with one entry moved by a thousandth of its largest value."""
    t = t.clone()
    flat = t.view(-1)
    i = flat.numel() // 3
    flat[i] += 1e-3 * flat.abs().max()
    return t


def _half(t: torch.Tensor) -> torch.Tensor:
    """t with the last half of its rows left at zero (x0)."""
    t = t.clone()
    t[..., t.shape[-1] // 2:] = 0
    return t


def plant(monkeypatch, traffic: dict, fault: str) -> None:
    """Plant ``fault`` in the timed path of a cell whose mix is
    ``traffic``: for ``cg`` in the loop of the mix's own ``variant``, the
    one that ``harness/traffic.py`` calls. A mix whose op or variant no
    plant reaches raises, so that no cell passes the fault test unfaulted."""
    op = traffic["op"]
    if op == "spmv":
        spmv = DiaMatrix.spmv
        wrong = {
            "state unchanged": lambda self, x: x.clone(),
            "half left out": lambda self, x: _half(spmv(self, x)),
            "answer altered": lambda self, x: _bump(spmv(self, x)),
        }[fault]
        monkeypatch.setattr(DiaMatrix, "spmv", wrong)
    elif op == "cg":
        variant = traffic["variant"]
        if variant not in cg_mod.CG_LOOPS:
            raise ValueError(f"no fault is planted in the cg variant "
                             f"{variant!r}: it is not a loop of CG_LOOPS")
        if fault == "state unchanged" and variant == "standard":
            # every body hands its state back as it came, k run out
            def stuck(A, state, k_end, *args, **kw):
                return (torch.tensor(k_end), *state[1:])

            monkeypatch.setattr(cg_mod, "cg_run", stuck)
            return
        loop = cg_mod.CG_LOOPS[variant]
        change = _half if fault == "half left out" else _bump

        def wrong(A, b, x0, itermax, *args, **kw):
            x, k, hist = loop(A, b, x0, itermax, *args, **kw)
            if fault == "state unchanged":
                # x as it came, k run out, the loop's own history
                return x0.clone(), torch.full_like(k, itermax), hist
            return change(x), k, hist

        monkeypatch.setitem(cg_mod.CG_LOOPS, variant, wrong)
    elif op == "cg_multi":
        loop = multi_mod.cg_multi_loop

        def wrong(A, B, X0, itermax, eps, acc_dtype=None):
            kcols = B.shape[0]
            if fault == "state unchanged":
                return (X0.clone(), torch.full((kcols,), itermax),
                        loop(A, B, X0, itermax, eps)[2])
            if fault == "half left out":
                # the first half of the columns solved, the rest left at X0
                h = kcols // 2
                X, iters, hist = loop(A, B[:h], X0[:h], itermax, eps)
                return (torch.cat([X, X0[h:]]), iters.repeat(2),
                        hist.repeat(1, 2))
            X, iters, hist = loop(A, B, X0, itermax, eps)
            return _bump(X), iters, hist

        monkeypatch.setattr(multi_mod, "cg_multi_loop", wrong)
    else:
        raise ValueError(f"no fault is planted in the traffic op {op!r}")


FAULTS = ["state unchanged", "half left out", "answer altered"]


@pytest.mark.parametrize("traffic", [
    {"op": "cg", "variant": "sstep"}, {"op": "cg", "variant": "pipe"},
    {"op": "gmres"}])
def test_a_fault_out_of_reach_raises(monkeypatch, traffic):
    with pytest.raises(ValueError, match="no fault is planted"):
        plant(monkeypatch, traffic, "answer altered")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch, Spec().traffic(Spec().cell(cell)["traffic"]), fault)
    r = cpu_run(cell)
    assert not r["correct"], (fault, r["checks"])
