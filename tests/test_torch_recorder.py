"""The port's own record of spans and counters (``sparsebench_tpu_torch/
profiler.py``), the spans its layers open, the kernel registry and the
CLI's ``--trace`` — without the JAX package.

Here on the CPU: the recorder off and on, the shape of a recorded solve,
the library loader's span, the clock against a CPU ``torch.profiler``
trace, the registry against every ``__global__`` kernel in ``csrc/`` and
the Chrome trace of ``--trace``. The test marked ``cuda`` (run on a card
with ``python -m pytest tests/test_torch_recorder.py --noconftest -q``)
holds every K1 launch of a traced window inside a ``dia.spmv`` span.
"""

import json
import re
import time
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sparsebench_tpu_torch import cli, profiler
from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.formats.stencil import StencilOperator
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.solvers.cg import CG_LOOPS, cg_loop
from sparsebench_tpu_torch.solvers.cg_multi import cg_multi_loop

CSRC = Path(profiler.__file__).resolve().parent / "csrc"
F32 = DTypePolicy.from_names("f32")
ITERMAX = 7


@pytest.fixture
def rec():
    profiler.RECORDER.clear()
    yield profiler
    profiler.set_mode("auto")
    profiler.RECORDER.clear()


def dia(device="cpu", n=(8, 7, 6)):
    A, _ = DiaMatrix.from_stencil(*n, device=device, policy=F32)
    return A


def children(spans, i):
    return [s for s in spans if s.parent == i]


def test_off_records_nothing(rec):
    A = dia()
    b = torch.ones(A.nr)
    for mode in ("auto", "off"):
        rec.set_mode(mode)
        assert not rec.recording()
        with rec.span("outer", x=1) as s:
            s.set(y=2)
            cg_loop(A, b, torch.zeros_like(b), ITERMAX, 0.0)
            rec.count("things", 3)
        assert rec.span_fn()("body") is rec.NO_SPAN
    # mode off holds even while a profiler session records
    with profile(activities=[ProfilerActivity.CPU]):
        assert not rec.recording()
        A.spmv(b)
    assert rec.spans() == [] and rec.counts() == {}
    with pytest.raises(ValueError):
        rec.set_mode("sometimes")


def test_auto_follows_a_profiler_session(rec):
    A = dia()
    b = torch.ones(A.nr)
    assert not rec.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert rec.recording()
        A.spmv(b)
    assert not rec.recording()
    A.spmv(b)
    assert [s.name for s in rec.spans()] == ["dia.spmv"]


def check_solve(spans, solve, init, body, spmv, attrs):
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert len(roots) == 1 and spans[roots[0]].name == solve
    assert spans[roots[0]].attrs == attrs
    kids = children(spans, roots[0])
    assert [s.name for s in kids] == [init] + [body] * (ITERMAX - 1)
    index = {id(s): i for i, s in enumerate(spans)}
    for s in kids[1:]:
        assert [c.name for c in children(spans, index[id(s)])] == [spmv]
    # the initial residual's product is the init's
    assert [c.name for c in children(spans, index[id(kids[0])])] == [spmv]
    assert {s.request for s in spans} == {spans[0].request}
    for s in spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_a_solve_is_one_span_with_its_init_and_bodies(rec):
    A = dia()
    b = torch.ones(A.nr)
    rec.set_mode("on")
    cg_loop(A, b, torch.zeros_like(b), ITERMAX, 0.0)
    spans = rec.spans()
    check_solve(spans, "cg.solve", "cg.init", "cg.body", "dia.spmv",
                {"variant": "standard", "itermax": ITERMAX, "n": A.nr,
                 "body": "torch"})
    assert {s.attrs["kernel"] for s in spans if s.name == "dia.spmv"} == {
        "torch"}
    # the CPU keeps the plain body: no fused body is counted
    assert rec.counts() == {"cg.bodies": ITERMAX - 1}


@pytest.mark.parametrize("vectors,kw", [
    ("f32", {}), ("f64", {}), ("bf16", {}),
    ("f32", {"inv_diag": True}),
])
def test_the_solve_span_names_its_body(rec, vectors, kw):
    """On the CPU every standard solve takes the plain body, preconditioned
    or not, in every dtype: ``body`` is ``torch`` and ``cg.kernel_bodies``
    is never counted."""
    A, _ = DiaMatrix.from_stencil(8, 7, 6, device="cpu",
                                  policy=DTypePolicy.from_names(vectors))
    dt = {"f32": torch.float32, "f64": torch.float64,
          "bf16": torch.bfloat16}[vectors]
    b = torch.ones(A.nr, dtype=dt)
    if kw:
        kw = {"inv_diag": torch.full_like(b, 1 / 26)}
    rec.set_mode("on")
    cg_loop(A, b, torch.zeros_like(b), ITERMAX, 0.0, **kw)
    solve = [s for s in rec.spans() if s.name == "cg.solve"]
    assert [s.attrs["body"] for s in solve] == ["torch"]
    assert rec.counts().get("cg.kernel_bodies", 0) == 0
    assert rec.counts()["cg.bodies"] == ITERMAX - 1


def test_a_blocked_solve_is_one_span_with_its_init_and_bodies(rec):
    A = dia()
    B = torch.rand(3, A.nr, generator=torch.Generator().manual_seed(5))
    rec.set_mode("on")
    cg_multi_loop(A, B, torch.zeros_like(B), ITERMAX, 0.0)
    spans = rec.spans()
    check_solve(spans, "cg_multi.solve", "cg_multi.init", "cg_multi.body",
                "dia.spmm", {"rhs": 3, "itermax": ITERMAX, "n": A.nr,
                             "body": "torch"})
    assert {s.attrs["kernel"] for s in spans if s.name == "dia.spmm"} == {
        "torch"}
    # the CPU keeps the eager loop: no fused body is counted
    assert rec.counts() == {"cg_multi.bodies": ITERMAX - 1}


@pytest.mark.parametrize("variant", sorted(CG_LOOPS))
def test_every_masked_loop_is_a_solve_span(rec, variant):
    A = StencilOperator.from_stencil(6, 5, 4, device="cpu", policy=F32)[0] \
        if variant in ("fused", "vmem") else dia()
    b = torch.ones(A.nr)
    rec.set_mode("on")
    x, k, _hist = CG_LOOPS[variant](A, b, torch.zeros_like(b), ITERMAX, 0.0)
    spans = rec.spans()
    solves = [s for s in spans if s.name == "cg.solve"]
    assert len(solves) == 1 and solves[0].attrs["variant"] == variant
    names = Counter(s.name for s in spans if s.parent == 0)
    bodies = 0 if variant == "vmem" else ITERMAX - 1
    # vmem: K5's whole solve, one span beside the init
    solve = int(variant == "vmem")
    assert names == Counter({"cg.init": 1, "cg.body": bodies,
                             "stencil.cg_vmem": solve}) - Counter()
    assert rec.counts().get("cg.bodies", 0) == bodies
    assert {s.request for s in spans} == {solves[0].request}


def test_spmv_calls_outside_a_solve_are_requests_of_their_own(rec):
    A = dia()
    rec.set_mode("on")
    for _ in range(3):
        A.spmv(torch.ones(A.nr))
    spans = rec.spans()
    assert [s.name for s in spans] == ["dia.spmv"] * 3
    assert len({s.request for s in spans}) == 3
    assert all(s.parent is None for s in spans)


def test_matrix_build_is_a_span_with_its_steps(rec):
    rec.set_mode("on")
    A = dia(n=(9, 8, 7))
    spans = rec.spans()
    assert [s.name for s in spans] == ["dia.build", "dia.build.diagonals",
                                       "dia.build.row_counts"]
    assert spans[0].attrs == {"n": A.nr, "points": 27}
    assert [s.parent for s in spans] == [None, 0, 0]


def test_library_load_is_a_span_with_built(rec, monkeypatch, tmp_path):
    """The loader's span and counter, with the compiler and dlopen stood in
    for: a first load builds, a second finds the library."""
    lib = tmp_path / "libfake.so"

    class FakeLib:
        class sb_cuda_error_string:
            pass

    def fake_build(names):
        lib.write_bytes(b"")
        return {n: lib for n in names}

    monkeypatch.setattr(_build, "library_path", lambda src: lib)
    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    monkeypatch.setattr(_build, "LOADS", [])
    rec.set_mode("on")
    load = _build.load_library.__wrapped__
    load("dia_spmv")
    load("dia_spmv")
    spans = rec.spans()
    assert [s.name for s in spans] == ["load_library"] * 2
    assert [s.attrs for s in spans] == [
        {"library": "dia_spmv", "built": True},
        {"library": "dia_spmv", "built": False}]
    assert rec.counts() == {"libraries_built": 1}
    assert [(x.library, x.built) for x in _build.LOADS] == [
        ("dia_spmv", True), ("dia_spmv", False)]
    assert all(x.seconds >= 0 for x in _build.LOADS)


def test_spans_share_the_profilers_clock(rec):
    """A span opened around a torch op encloses that op's event in a
    CPU-activity trace: both stamp the same clock."""
    x = torch.randn(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("around"):
            time.sleep(0.002)
            x.mul(3.0)
            time.sleep(0.002)
    (s,) = rec.spans()
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mul" and e.device_type() == DeviceType.CPU]
    assert ops
    for e in ops:
        assert s.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s.end_ns


def test_annotate_sets_the_innermost_open_span(rec):
    profiler.annotate(form="row")  # nothing open: nothing happens
    rec.set_mode("on")
    with rec.span("outer"):
        with rec.span("inner"):
            profiler.annotate(form="quad")
    outer, inner = rec.spans()
    assert outer.attrs == {} and inner.attrs == {"form": "quad"}


def test_export_writes_the_record(rec, tmp_path):
    rec.set_mode("on")
    with rec.span("a", k=1):
        rec.count("n", 2)
        with rec.span("b"):
            pass
    path = tmp_path / "record.json"
    rec.export(str(path))
    data = json.loads(path.read_text())
    assert [s["name"] for s in data["spans"]] == ["a", "b"]
    assert data["spans"][1]["parent"] == 0
    assert data["spans"][0]["attrs"] == {"k": 1}
    assert data["counts"][0]["name"] == "n" and data["counts"][0]["n"] == 2
    assert data["counts"][0]["parent"] == 0


def global_kernels():
    """Every ``__global__`` function defined in ``csrc/*.cu``."""
    names = set()
    for src in sorted(CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"__global__\s+void\s+(?:(?:__launch_bounds__|"
                             r"__maxnreg__)\s*"
                             r"\([^)]*(?:\([^)]*\)[^)]*)*\)\s*)?(\w+)", text):
            names.add(m.group(1))
    return names


def test_registry_covers_every_kernel_in_csrc():
    kernels = profiler.kernels()
    found = global_kernels()
    assert len(found) >= 16
    named = {n for k in kernels.values() for n in k.names}
    assert found - named == set(), "kernels without a registry entry"
    assert named - found == set(), "registry names no kernel defines"
    for k in kernels.values():
        assert k.layer in profiler.LAYERS, k
        assert k.wrappers and k.launches >= 0
    ids = sorted(kernels)
    assert ids == sorted([f"K{i}" for i in range(1, 13)] + ["K14", "K15"]
                         + [f"P{i}" for i in range(1, 6)])


def test_registry_reads_the_wrappers_counters():
    from sparsebench_tpu_torch.ops import dia_spmv as k1

    before = profiler.kernels()["K1"].launches
    k1.dia_spmv.launches += 2
    try:
        assert profiler.kernels()["K1"].launches == before + 2
    finally:
        k1.dia_spmv.launches -= 2


@pytest.mark.parametrize("event,ids", [
    ("void (anonymous namespace)::dia_spmv_kernel<__nv_bfloat16, float>"
     "(__nv_bfloat16 const*, float const*)", ("K1",)),
    ("dia_spmm_quad_kernel<float, float>", ("K8",)),
    ("void (anonymous namespace)::dia_spmm_kernel_staged<__nv_bfloat16, "
     "float>(__nv_bfloat16 const*, float const*)", ("K8",)),
    ("void bsell_spmv_win_kernel<float>(int const*)", ("K10", "K11")),
    ("void at::native::vectorized_elementwise_kernel<4>()", ()),
])
def test_kernels_named_by_device_event(event, ids):
    assert tuple(k.id for k in profiler.kernels_named(event)) == ids


def test_cli_trace_holds_the_program_spans(rec, tmp_path, capsys):
    logdir = tmp_path / "trace"
    assert cli.main(["-t", "cg", "-x", "6", "-y", "5", "-z", "4", "-i", "5",
                     "--device", "cpu", "--trace", str(logdir)]) == 0
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    program = [e for e in events if e.get("cat") == "program"]
    names = Counter(e["name"] for e in program)
    # solve_cg runs a warm-up solve, then the timed one
    assert names["cg.solve"] == 2 and names["cg.body"] == 2 * 4
    assert names["dia.spmv"] == 2 * 5
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in program)
    # no host operations are recorded
    assert not [e for e in events if e.get("cat") == "cpu_op"]
    # the recorder is back in its mode, and records nothing after
    assert profiler.recording() is False


def test_trace_without_a_directory_records_nothing(rec):
    with profiler.trace(None):
        dia().spmv(torch.ones(336))
    assert rec.spans() == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_every_k1_launch_lies_inside_its_span(rec, cuda_device):
    """On the card: a traced window of K1 SpMVs; every ``dia_spmv_kernel``
    has a runtime launch event of its correlation id whose start lies in a
    ``dia.spmv`` span, so spans and device events share a clock."""
    A = dia(cuda_device, n=(64, 64, 64))
    x = torch.rand(A.nr, device=cuda_device)
    A.spmv(x)
    torch.cuda.synchronize()
    # every library built first: a session opened after nvcc ran in the
    # process can miss device events
    _build.build()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            A.spmv(x)
        torch.cuda.synchronize()
    spans = [s for s in rec.spans() if s.name == "dia.spmv"]
    assert len(spans) == 50
    assert {s.attrs["kernel"] for s in spans} == {"K1"}
    events = prof.profiler.kineto_results.events()
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and profiler.device_name(e.name()) == "dia_spmv_kernel"]
    launches = {e.correlation_id(): e for e in events
                if e.device_type() == DeviceType.CPU
                and "LaunchKernel" in e.name()}
    assert len(kernels) == 50
    for k in kernels:
        launch = launches[k.correlation_id()]
        t = launch.start_ns()
        assert any(s.start_ns <= t <= s.end_ns for s in spans), t
        assert t <= k.start_ns()


@pytest.mark.cuda
@pytest.mark.parametrize("vectors,jacobi,body", [
    ("f32", False, "kernel"), ("f64", False, "kernel"),
    ("bf16", False, "torch"), ("f32", True, "torch"),
])
def test_card_solves_name_their_body(rec, cuda_device, vectors, jacobi, body):
    """On the card: f32 and f64 solves take the fused body (K15) and count
    each body in ``cg.kernel_bodies``; bf16 vectors and PCG keep the plain
    body and count none."""
    A, _ = DiaMatrix.from_stencil(16, 16, 16, device=cuda_device,
                                  policy=DTypePolicy.from_names(vectors))
    dt = {"f32": torch.float32, "f64": torch.float64,
          "bf16": torch.bfloat16}[vectors]
    b = torch.ones(A.nr, dtype=dt, device=cuda_device)
    kw = {"inv_diag": torch.full_like(b, 1 / 26)} if jacobi else {}
    rec.set_mode("on")
    cg_loop(A, b, torch.zeros_like(b), ITERMAX, 0.0, **kw)
    torch.cuda.synchronize()
    solve = [s for s in rec.spans() if s.name == "cg.solve"]
    assert [s.attrs["body"] for s in solve] == [body]
    counts = rec.counts()
    assert counts["cg.bodies"] == ITERMAX - 1
    assert counts.get("cg.kernel_bodies", 0) == (
        ITERMAX - 1 if body == "kernel" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("vectors,body", [
    ("f32", "kernel"), ("f64", "kernel"), ("bf16", "torch"),
])
def test_card_blocked_solves_name_their_body(rec, cuda_device, vectors,
                                             body):
    """On the card: f32 and f64 blocked solves take K15 and count every
    body in ``cg_multi.kernel_bodies`` beside ``cg_multi.bodies``; bf16
    vectors keep the eager loop and count none."""
    A, _ = DiaMatrix.from_stencil(16, 16, 16, device=cuda_device,
                                  policy=DTypePolicy.from_names(vectors))
    dt = {"f32": torch.float32, "f64": torch.float64,
          "bf16": torch.bfloat16}[vectors]
    B = torch.ones((3, A.nr), dtype=dt, device=cuda_device)
    rec.set_mode("on")
    cg_multi_loop(A, B, torch.zeros_like(B), ITERMAX, 0.0)
    torch.cuda.synchronize()
    solve = [s for s in rec.spans() if s.name == "cg_multi.solve"]
    assert [s.attrs["body"] for s in solve] == [body]
    counts = rec.counts()
    assert counts["cg_multi.bodies"] == ITERMAX - 1
    assert counts.get("cg_multi.kernel_bodies", 0) == (
        ITERMAX - 1 if body == "kernel" else 0)
