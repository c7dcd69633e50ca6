"""Every piece is found by the name BENCHMARK.json gives it, and a piece
added as a file and an entry is taken with no edit of a file there."""

import json
import shutil

import pytest
import torch

import run
from harness.spec import ROOT, Spec
from test_run import FAULTS, plant

SMALL = {"nx": 20, "ny": 19, "nz": 18, "itermax": 60}


def test_every_named_piece_is_found():
    spec = Spec()
    for c in spec.bench["configs"]:
        cfg = spec.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in spec.bench["workloads"]:
        assert spec.traffic(w["traffic"])["op"]
        assert spec.limits(w["name"])
        e2e = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer(w["name"])
    for m in spec.bench["per_layer"]:
        assert callable(spec.reader(m["name"]).read)
        assert m["moves"] in {e["name"] for e in spec.bench["end_to_end"]}


def test_unknown_names_raise():
    spec = Spec()
    with pytest.raises(KeyError):
        spec.cell("no-such.cell")
    with pytest.raises(KeyError):
        spec.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        spec.traffic("no-such-traffic")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


@pytest.fixture
def copy(tmp_path):
    """A checkout of BENCHMARK.json and bench_torch/ alone."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench_torch", tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def files(root) -> dict:
    """Every file under ``root``'s bench_torch/ with its bytes."""
    return {p: p.read_bytes() for p in (root / "bench_torch").rglob("*")
            if p.is_file()}


def add_cell(root, config: str, changes: dict, traffic: str,
             mix: dict) -> str:
    """A cell added to the checkout at ``root`` as files and entries alone:
    the configuration ``config`` (hpcg27-200's with ``changes``), the mix
    ``traffic`` (cg's with ``mix``), the cell's limits (hpcg27-200.cg's)
    and a reader ``solves.<traffic>``. Returns the cell's name."""
    bench = root / "bench_torch"
    cfg = json.loads((bench / "configs" / "hpcg27-200.json").read_text())
    (bench / "configs" / f"{config}.json").write_text(
        json.dumps(dict(cfg, name=config, **changes)))
    cg = json.loads((bench / "traffic" / "cg.json").read_text())
    (bench / "traffic" / f"{traffic}.json").write_text(
        json.dumps(dict(cg, **mix)))
    cell = f"{config}.{traffic}"
    shutil.copy(bench / "limits" / "hpcg27-200.cg.json",
                bench / "limits" / f"{cell}.json")
    (bench / "metrics" / f"solves.{traffic}.py").write_text(
        "def read(ctx):\n    return float(ctx.ops)\n")
    spec_json = json.loads((root / "BENCHMARK.json").read_text())
    spec_json["configs"].append(dict(
        spec_json["configs"][0], name=config,
        file=f"bench_torch/configs/{config}.json"))
    spec_json["workloads"].append(
        {"name": cell, "config": config, "traffic": traffic, "chips": 1,
         "why": "a test"})
    spec_json["per_layer"].append(
        {"name": f"solves.{traffic}", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "solver loops",
         "moves": "solve_ms", "workloads": [cell]})
    for m in spec_json["end_to_end"]:
        if "workloads" in m and "hpcg27-200.cg" in m["workloads"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))
    return cell


def test_added_files_are_taken_without_edit(copy):
    before = files(copy)
    # a new traffic mix, its cell's limits, a new configuration and metric
    cell = add_cell(copy, "hpcg27-small", SMALL, "cg-pool2",
                    {"pool": 2, "check_sample": 2})
    spec = Spec(copy)
    assert spec.traffic("cg-pool2")["pool"] == 2
    assert spec.config("hpcg27-small")["nx"] == SMALL["nx"]
    assert spec.reader("solves.cg-pool2").read(type("C", (), {"ops": 3})) == 3.0
    assert {m["name"] for m in spec.end_to_end(cell)} == {
        "setup_s", "solve_ms", "solve_p95_ms"}
    # the new cell runs through the same harness, its files read by name
    result = run.run(spec, cell, 11, 0.3, False, torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


@pytest.mark.parametrize("variant", ["vmem", "fused"])
def test_a_matrix_free_cell_is_taken_without_edit(copy, monkeypatch,
                                                  variant):
    """The operator applied matrix-free, under a mix of another CG loop
    than ``standard``: the sound run is correct, and the control and each
    fault planted in that loop are not."""
    before = files(copy)
    cell = add_cell(copy, "hpcg27-small-mfree",
                    dict(SMALL, format="stencil", operator="matrix-free"),
                    variant, {"variant": variant})
    spec = Spec(copy)
    assert {m["name"] for m in spec.end_to_end(cell)} == {
        "setup_s", "solve_ms", "solve_p95_ms"}
    assert [m["name"] for m in spec.per_layer(cell)] == [f"solves.{variant}"]
    cpu = torch.device("cpu")
    sound = run.run(spec, cell, 13, 0.3, False, cpu)
    assert sound["correct"], sound["checks"]
    assert sound["attempted"] >= 1 and sound["failed"] == 0
    control = run.run(spec, cell, 13, 0.3, False, cpu, control=True)
    assert not control["correct"], control["checks"]
    for fault in FAULTS:
        with monkeypatch.context() as m:
            plant(m, spec.traffic(variant), fault)
            r = run.run(spec, cell, 13, 0.3, False, cpu)
        assert not r["correct"], (fault, r["checks"])
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
