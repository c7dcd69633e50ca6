"""Every piece is found by the name BENCHMARK.json gives it, and a piece
added as a file and an entry is taken with no edit of a file there."""

import json
import shutil

import pytest
import torch

import run
from harness.spec import ROOT, Spec

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


def test_added_files_are_taken_without_edit(copy):
    before = {p: p.read_bytes() for p in (copy / "bench_torch").rglob("*")
              if p.is_file()}
    bench = copy / "bench_torch"
    # a new traffic mix, its cell's limits, a new configuration and metric
    mix = json.loads((bench / "traffic" / "cg.json").read_text())
    (bench / "traffic" / "cg-pool2.json").write_text(
        json.dumps(dict(mix, pool=2, check_sample=2)))
    shutil.copy(bench / "limits" / "hpcg27-200.cg.json",
                bench / "limits" / "hpcg27-small.cg-pool2.json")
    cfg = json.loads((bench / "configs" / "hpcg27-200.json").read_text())
    (bench / "configs" / "hpcg27-small.json").write_text(
        json.dumps(dict(cfg, name="hpcg27-small", **SMALL)))
    (bench / "metrics" / "solves.cg-pool2.py").write_text(
        "def read(ctx):\n    return float(ctx.ops)\n")
    spec_json = json.loads((copy / "BENCHMARK.json").read_text())
    spec_json["configs"].append(dict(
        spec_json["configs"][0], name="hpcg27-small",
        file="bench_torch/configs/hpcg27-small.json"))
    spec_json["workloads"].append(
        {"name": "hpcg27-small.cg-pool2", "config": "hpcg27-small",
         "traffic": "cg-pool2", "chips": 1, "why": "a test"})
    spec_json["per_layer"].append(
        {"name": "solves.cg-pool2", "unit": "count", "better": "higher",
         "source": "program_counter", "layer": "solver loops",
         "moves": "solve_ms", "workloads": ["hpcg27-small.cg-pool2"]})
    for m in spec_json["end_to_end"]:
        if "workloads" in m and "hpcg27-200.cg" in m["workloads"]:
            m["workloads"].append("hpcg27-small.cg-pool2")
    (copy / "BENCHMARK.json").write_text(json.dumps(spec_json))

    spec = Spec(copy)
    assert spec.traffic("cg-pool2")["pool"] == 2
    assert spec.config("hpcg27-small")["nx"] == SMALL["nx"]
    assert spec.reader("solves.cg-pool2").read(type("C", (), {"ops": 3})) == 3.0
    assert {m["name"] for m in spec.end_to_end("hpcg27-small.cg-pool2")} == {
        "setup_s", "solve_ms", "solve_p95_ms"}
    # the new cell runs through the same harness, its files read by name
    result = run.run(spec, "hpcg27-small.cg-pool2", 11, 0.3, False,
                     torch.device("cpu"))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
