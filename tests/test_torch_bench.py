"""The port's bench suite (``python -m sparsebench_tpu_torch.bench``) on the
CPU: its final-line budget and priority order against the repository's
root bench.py, the roofline denominator, the physical byte model against
the JAX package's ``physical_spmv_bytes``, every section at a test size
(``--device cpu``: the plain PyTorch path, numbers of the CPU), and the exit
code when a section fails.
"""

import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from sparsebench_tpu.config import DTypePolicy as JaxPolicy
from sparsebench_tpu.formats import from_csr as jax_from_csr
from sparsebench_tpu.formats.base import physical_spmv_bytes
from sparsebench_tpu.formats.bsell import BsellMatrix as JaxBsell
from sparsebench_tpu.formats.bslab import BslabMatrix as JaxBslab
from sparsebench_tpu.formats.dia import DiaMatrix as JaxDia
from sparsebench_tpu.formats.stencil import StencilOperator as JaxStencil
from sparsebench_tpu.host import generate_stencil as jax_generate_stencil
from sparsebench_tpu_torch import bench
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats import from_csr
from sparsebench_tpu_torch.formats.bsell import BsellMatrix
from sparsebench_tpu_torch.formats.bslab import BslabMatrix
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.formats.stencil import StencilOperator
from sparsebench_tpu_torch.host import generate_stencil
from sparsebench_tpu_torch.ops.memroof import read_passes

CPU = torch.device("cpu")
ROOT_BENCH = pathlib.Path(__file__).resolve().parent.parent / "bench.py"


def root_bench():
    """The root bench.py, which imports only numpy at its top level."""
    spec = importlib.util.spec_from_file_location("root_bench", ROOT_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_compact_priority_is_the_root_benchs():
    assert bench._COMPACT_PRIORITY == root_bench()._COMPACT_PRIORITY
    assert bench._TAIL_BUDGET == 1500
    # the emit order is the root order with the K12 ceiling after STREAM's
    assert [k for k in bench._EMIT_ORDER if k != "dma_read_GBps"] == list(
        bench._COMPACT_PRIORITY)
    assert bench._EMIT_ORDER.index("dma_read_GBps") == 2


@pytest.mark.parametrize("n_extra", [3, 400])
def test_emit_final_line_fits_and_parses(n_extra, capsys):
    extra = {f"zz_key_{i:04d}": 1234.5678 + i for i in range(n_extra)}
    extra.update({"dma_read_GBps": 3000.1, "stream_read_GBps": 2900.2,
                  "cg200_seconds": 0.0951})
    payload = {"metric": "m", "value": 0.05, "unit": "s",
               "vs_baseline": None, "device": "card", "extra": extra}
    assert bench.emit(payload, rc=3) == 3
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0]) == payload
    last = json.loads(lines[-1])
    assert len(lines[-1]) <= bench._TAIL_BUDGET
    assert last["value"] == 0.05 and last["vs_baseline"] is None
    for key in ("dma_read_GBps", "stream_read_GBps", "cg200_seconds"):
        assert last["extra"][key] == extra[key]
    if n_extra == 3:
        assert len(lines) == 1
    else:
        assert len(lines) == 2
        assert last["extra_dropped"] == len(extra) - len(last["extra"]) > 0


def test_nominal_rate_of_the_card():
    assert bench.nominal_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert bench.nominal_hbm_gbps("NVIDIA A100-SXM4-80GB") is None
    assert bench.nominal_hbm_gbps("NVIDIA H100 PCIe") is None
    assert 819.0 not in dict(bench.NOMINAL_HBM_GBPS).values()


@pytest.mark.parametrize("measured,nominal,expect", [
    ((2900.0, 3000.0, 3100.0), 3350.0, (3350.0, False)),
    ((2900.0, None, 3400.0), 3350.0, (3400.0, False)),  # within 1.02x
    ((2900.0, 3500.0, None), 3350.0, (3350.0, True)),   # above: excluded
    ((None, None, None), 3350.0, (3350.0, False)),
    ((1500.0, 1600.0, None), None, (1600.0, False)),    # unknown card
    ((None, None, None), None, (None, False)),
])
def test_roofline_denominator(measured, nominal, expect):
    assert bench.roofline_denominator(*measured, nominal=nominal) == expect


def phys_pair(fmt, n):
    jp = JaxPolicy.from_names("f32", "i32")
    tp = DTypePolicy.from_names("f32", "i32")
    if fmt == "dia":
        return (JaxDia.from_stencil(n, n, n, policy=jp, impl="xla")[0],
                DiaMatrix.from_stencil(n, n, n, policy=tp, device=CPU)[0])
    if fmt == "bslab":
        return (JaxBslab.from_stencil(n, n, n, policy=jp, impl="xla")[0],
                BslabMatrix.from_stencil(n, n, n, policy=tp, device=CPU)[0])
    if fmt == "bsell":  # the device build, as the bench's spmv mode takes
        return (JaxBsell.from_stencil(n, n, n, policy=jp, impl="xla")[0],
                BsellMatrix.from_stencil(n, n, n, policy=tp, device=CPU)[0])
    if fmt == "stencil":
        return (JaxStencil.from_stencil(n, n, n, policy=jp)[0],
                StencilOperator.from_stencil(n, n, n, policy=tp,
                                             device=CPU)[0])
    # sell bridged to its bslab delegate on both sides, as the benches
    # measure it: only the delegate's arrays count
    return (jax_from_csr("sell", jax_generate_stencil(
        n, n, n, dtype=np.float32), jp, bridge=True),
            from_csr("sell", generate_stencil(n, n, n), tp, device=CPU,
                     bridge=True))


@pytest.mark.parametrize("fmt", ["dia", "bslab", "sell", "stencil", "bsell"])
def test_phys_gbps_counts_the_jax_byte_model(fmt):
    Aj, At = phys_pair(fmt, 12)
    nbytes = physical_spmv_bytes(Aj, 4)
    assert nbytes > 0
    assert bench.phys_gbps(At, 1.0) * 1e9 == pytest.approx(nbytes, rel=1e-12)
    assert bench.phys_gbps(At, 2e-3) == pytest.approx(nbytes / 2e-3 / 1e9,
                                                      rel=1e-12)


# -- every section at a test size on the CPU ----------------------------------


@pytest.fixture(scope="module")
def suite():
    """A suite at test sizes with its ceilings and 100^3-slot problem in
    place, shared by the section tests below."""
    s = bench.Suite(device=CPU, sizes=bench.Sizes.small())
    bench.section_build(s)  # nothing to build on the CPU
    assert "kernel_build_seconds" not in s.extra
    before = read_passes.launches
    bench.section_ceilings(s)
    assert read_passes.launches == before  # the plain version on the CPU
    bench.section_cg100(s)
    assert not s.failures
    return s


def test_ceilings_and_headline_sections(suite):
    # the rates: the unrounded ceilings (the line rounds to 0.1 GB/s, which
    # a loaded CPU's may fall below); the seconds as the line has them
    assert suite.sizes.dma_floats == suite.sizes.dma_tile_rows * 128
    assert min(suite.stream, suite.read_bw, suite.dma) > 0
    for key in ("stream_triad_GBps", "stream_read_GBps", "dma_read_GBps"):
        assert suite.extra[key] >= 0
    for key in ("setup100_seconds", "cg100_cs_seconds"):
        assert suite.extra[key] > 0
    # no data-sheet rate on the CPU: the best measured ceiling
    assert suite.nominal is None
    assert suite.roof == pytest.approx(max(
        suite.stream, suite.extra["stream_read_GBps"],
        suite.extra["dma_read_GBps"]), abs=0.051)
    assert suite.best100 > 0 and suite.extra["cg100_variant"] in (
        "standard", "cs")


@pytest.mark.parametrize("section,keys", [
    (bench.section_spmv100, ["spmv_GBps", "spmv100_phys_GBps"]),
    (bench.section_dia200, ["spmv200_GBps", "spmv200_phys_GBps",
                            "spmv_frac_of_stream", "cg200_seconds"]),
    (bench.section_bslab200, ["spmv200_bslab_phys_GBps", "cg200_bslab_seconds",
                              "spmv200_bslab_f32_phys_GBps"]),
    (bench.section_bslab100, ["cg100_bslab_seconds"]),
    (bench.section_sell100, ["spmv100_sell_phys_GBps", "sell_vs_bslab_ratio"]),
    (bench.section_stencil, ["stencilfree100_spmv_ms", "cg100_fused_seconds",
                             "cg100_stencilfree_seconds",
                             "cg200_stencilfree_seconds"]),
    (bench.section_vmem200, ["cg200_vmem_seconds"]),
    (bench.section_mixed, ["cg200_stencil_bf16_seconds",
                           "cg200_refine_seconds"]),
    (bench.section_7pt, ["cg100_7pt_seconds"]),
    (bench.section_rgl, ["rgl_nnz", "rgl_spmv_phys_GBps", "rgl_cg150_seconds"]),
    (bench.section_solvers, ["gmres100_seconds", "bicgstab100_seconds",
                             "minres100_seconds", "cheb100_seconds",
                             "gmres100_jacobi_iters_to_1e8",
                             "gmres100_cheb_iters_to_1e8",
                             "gmres_klein_seconds"]),
    (bench.section_cg_multi, ["cg100_nrhs8_seconds", "cg100_nrhs8_speedup"]),
], ids=lambda v: v.__name__ if callable(v) else None)
def test_section_runs_on_the_cpu(suite, section, keys):
    section(suite)
    assert not suite.failures
    for key in keys:
        v = suite.extra[key]
        # rates are rounded to 0.1 GB/s, below which the CPU's may fall
        assert math.isfinite(v) and (v >= 0 if "GBps" in key else v > 0), key


def test_a_failing_section_makes_the_exit_code_1(monkeypatch, capsys):
    def broken(s):
        raise RuntimeError("section broke")

    monkeypatch.setattr(bench, "SECTIONS", (
        ("ceilings", bench.section_ceilings), ("cg 100^3",
                                               bench.section_cg100),
        ("broken", broken)))
    assert bench.run_suite(CPU, bench.Sizes.small()) == 1
    captured = capsys.readouterr()
    last = json.loads(captured.out.strip().splitlines()[-1])
    assert last["value"] > 0 and last["vs_baseline"] is None
    assert last["device"] == "cpu"
    assert "broken failed: RuntimeError('section broke')" in captured.err
    assert "1 failure(s); exit 1" in captured.err

    monkeypatch.setattr(bench, "SECTIONS", bench.SECTIONS[:2])
    assert bench.run_suite(CPU, bench.Sizes.small()) == 0
    capsys.readouterr()


def test_an_invalid_result_is_a_failure(monkeypatch, capsys):
    """A section whose solves are all INVALID is logged and fails the run;
    nothing falls back to another path."""
    monkeypatch.setattr(bench, "timed_cg", lambda *a, **k: None)
    monkeypatch.setattr(bench, "SECTIONS", (
        ("cg 100^3", bench.section_cg100),))
    assert bench.run_suite(CPU, bench.Sizes.small()) == 1
    err = capsys.readouterr().err
    assert "every attempt INVALID" in err and "no valid 100^3 CG time" in err


def test_cg_and_spmv_modes(capsys):
    assert bench.main(["--device", "cpu", "cg", "8"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "cg_stencil8cubed_150iter_solve_seconds"
    assert line["value"] > 0 and line["vs_baseline"] is None
    assert bench.main(["--device", "cpu", "spmv", "8", "dia,sell"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"].startswith("spmv_effective_bandwidth_8cubed_")
    assert line["value"] > 0 and line["vs_baseline"] is None
    # a format that fails is logged and makes the exit code 1
    assert bench.main(["--device", "cpu", "spmv", "8", "dia,nosuch"]) == 1
    captured = capsys.readouterr()
    assert "nosuch: failed" in captured.err
    assert json.loads(captured.out.strip().splitlines()[-1])["value"] > 0


def test_default_device_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    captured = capsys.readouterr()
    assert not captured.out
    assert "torch.cuda.is_available() is False" in captured.err
