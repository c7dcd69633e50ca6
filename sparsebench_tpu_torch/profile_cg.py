"""Where the time of one CG solve goes, on a CUDA card.

    python -m sparsebench_tpu_torch.profile_cg [-n 100 200] [-i 150]
        [--fmt dia|stencil|bslab|bsell|rgl]
        [--variant standard|cs|sstep|pipe|fused|vmem]
        [--solver cg|nrhs|gmres|cheb|bicgstab|minres]
    python -m sparsebench_tpu_torch.profile_cg --patterns [-n 100 200]
    python -m sparsebench_tpu_torch.profile_cg --k8-variants [-n 100 200]
        [--against DIR]
    python -m sparsebench_tpu_torch.profile_cg --k8-forms [-n 100 200]
    python -m sparsebench_tpu_torch.profile_cg --stencil-plans [-n 100 200]
        [--against DIR] [--stencil-variants]
    python -m sparsebench_tpu_torch.profile_cg --vmem-variants [-n 100 200]
        [--against DIR]

For each size n, f32 vectors: the n^3 generated stencil as DIA with bf16
diagonals (K1), as the matrix-free stencil operator (K2-K5), as bslab
(K6) or as bsell (K9, built on the device as the bench builds it); or,
with ``--fmt rgl``, the RGL matrix of n rows (band 512, deg 16, seed 1;
bslab, K6) with a seeded random b (b = 1 is an eigenvector of it, on which
CG stops after one step). It prints:

* the wall of one solve loop (``--solver cg``: the CG variant's loop;
  ``nrhs``: blocked CG over ``NRHS`` copies of b, K8 on DIA; ``gmres``:
  itermax/30 restart cycles; ``cheb``, ``bicgstab``, ``minres``: their
  loops, Chebyshev's bounds estimated once beforehand): host clock ending
  in a synchronise, best of 3, without the profiler;
* under ``torch.profiler``: the device-busy time and its share of that
  wall, the port's own kernels' share of device time and each of their
  device times and launch counts by name, device kernels per iteration
  and the heaviest kernels;
* the wall of one CUDA-graph replay of the same loop, which drops the host's
  launch overhead, and whether its result equals the eager one (not for
  ``vmem``, which is one cooperative launch, nor for the loops that read a
  flag on the host: ``sstep``, ``pipe`` and GMRES's restarts).

``--patterns`` times the multi-RHS DIA kernel (K8) instead: for the n^3
stencil as DIA (27 diagonals, bf16) and for synthetic diagonal patterns of
the same length (one diagonal; 27 consecutive offsets; one offset in each
of 3 planes; 9 rows of 3 planes), at each k of ``PATTERN_KS``, K8 on a
(k, n^3) f32 block against k K1 calls on its rows, each the better of two
CUDA-graph replays of 20 calls timed with CUDA events, with the bytes K8
moves at least (diagonals once, X and Y once). The patterns separate the
cost of the matrix stream from that of the shifted x loads.

``--k8-variants`` times designs of K8 that differ from this tree's by one
edit of ``csrc/dia_spmm.cu`` (``K8_VARIANTS``: the staged form's stages,
columns a thread, the unrolled runs of three, the planes a run and the
registers a thread; and
two diagnostics that give wrong sums on purpose: X copied only for a
block's first units, so the sums and the data copies, and no sums at
all, the copies alone), each written to ``build/k8_variants/`` and built
with this tree's flags, and this tree's kernel under the staged plans of
``K8_PLANS`` (rows a unit, columns a stage), on the n^3 stencil at k = 8,
in turns with this tree's K8 (this, the others, the others again in
reverse, this), beside its bound; with ``--against DIR`` another tree's
K8 among them (for instance the parent, unpacked with ``git archive``).
Every variant but the diagnostics is first held to this tree's result bit
for bit.

``--k8-forms`` times K8's staged form against its four-row form in turns
(four-row, staged, staged, four-row, four-row, staged) at the inputs of
``K8_FORMS`` whose n is among ``-n`` (the 27- and 7-point stencils, the
three dtype pairs, several k), each where ``staged_plan`` admits the
staged form, with the form that ``spmm_plan`` picks, after holding the two
to each other bit for bit.

``--stencil-plans`` times the stencil kernels K2 (the apply) and K3 (the
fused p-update, apply and dot) on the n^3 grid, f32, under the default
tile plan (``device_plan``) and under each forced plan of
``STENCIL_PLANS`` (R rows a thread, tz planes a run), in turns (the
default, the others, the others again in reverse, the default), each first
held bit for bit to the plain version; with ``--against DIR`` another
tree's K2 and K3 among them (``profile_bslab.lib_k2``, ``lib_k3``), its
outputs held to this tree's; with ``--stencil-variants`` also the kernels
of ``STENCIL_VARIANTS``, each one edit of ``csrc/stencil.cu`` away
(written to ``build/stencil_variants/``), on the default plan. Beside
each: the share of the bytes bound (x read and y written; K3 r and p read,
p' and w written; 3.35 TB/s).

``--vmem-variants`` times the one-launch CG kernel K5 (a whole solve of
``-i`` iterations, f32, 27-point, from x0 = 0 on the generated problem) on
its default plan beside forced plans (``VMEM_PLANS``: the march's R and
tz, the ring's tz) and beside the kernels of
``VMEM_VARIANTS``, each one edit of ``csrc/stencil_cg_vmem.cu`` away
(written to ``build/vmem_variants/``): phase B with one value a load
instead of 16 bytes, the kernel bounded to four blocks an SM, or its
ring form alone to three or four (the source note gives the design
choices that were measured this way and the losers deleted), and a
diagnostic whose results are wrong on purpose, the ring's copies and
stores without its sums. Then the phase
split (``VMEM_PHASES``): phase A alone and phase B alone, each one edit
away, of this tree and, with ``--against DIR``, of that tree too, whose K5
is timed among them (``profile_bslab.lib_k5``); each keeps both barriers,
and a line per tree reads phase A as the whole less phase B alone, phase
B as the whole less phase A alone, and the barriers as the rest. A phase
alone also loses what the other phase left in the L2 (w and p' for phase
B, r for phase A), so the two estimates are upper bounds and the
barriers' share a lower one. Each variant that solves CG is first held
to this tree's result: k equal, the history to rtol 1e-4 above 1e-4 of
its start, x to 1e-4 (bit for bit where its sums run in this tree's
order: a variant that keeps the plan and the order of the dots); then all
are timed in turns (this, the others, the others again in reverse, this),
each the better of its runs of ``VMEM_REPS`` back-to-back solves timed
with CUDA events. Beside each: the share of K5's bound (chip_smoke.py
phase 5b: r0 and x0 read, x written, and each iteration the part of r, p
and x beyond the L2 read and written; 3.35 TB/s).

``SB_FUSED_CS=1`` in the environment selects the fused ``cs`` body, as it
does for the CLI. Every time line carries the card's name and power limit
from nvidia-smi.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.bsell import BsellMatrix
from sparsebench_tpu_torch.formats.bslab import BslabMatrix
from sparsebench_tpu_torch.formats.dia import DiaMatrix
from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab
from sparsebench_tpu_torch.formats.stencil import StencilOperator
from sparsebench_tpu_torch.ops.dia_spmm import dia_spmm
from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv
from sparsebench_tpu_torch.profiler import device_name, kernels_named
from sparsebench_tpu_torch.solvers.bicgstab import bicgstab_loop
from sparsebench_tpu_torch.solvers.cg import (
    CG_LOOPS,
    CG_VARIANTS,
    init_vectors,
    resolve_cg_loop,
)
from sparsebench_tpu_torch.solvers.cg_multi import cg_multi_loop
from sparsebench_tpu_torch.solvers.chebyshev import cheby_loop, estimate_bounds
from sparsebench_tpu_torch.solvers.gmres import gmres_cycle
from sparsebench_tpu_torch.solvers.minres import minres_loop

SOLVERS = ("cg", "nrhs", "gmres", "cheb", "bicgstab", "minres")
GMRES_RESTART = 30
NRHS = 8  # right-hand sides of --solver nrhs
PATTERN_KS = (1, 2, 4, 8, 16)  # block widths of --patterns
OPERATORS = {"dia": DiaMatrix, "stencil": StencilOperator,
             "bslab": BslabMatrix, "bsell": BsellMatrix}
# --k8-variants: (name, edits of csrc/dia_spmm.cu, its result is right)
_X_COPY = ("          sb::bulk_load(seg + z0, x + (run.c0 + c) * ldx + lo, b, full + s);\n"
           "          bytes += b;\n")
K8_VARIANTS = (
    ("two stages", [("kMarchStages = 3;", "kMarchStages = 2;")], True),
    ("8 columns a thread", [("kThreadCols = 4;", "kThreadCols = 8;")], True),
    ("chunks in a loop", [("bool run3 = runs.count == 9;",
                           "bool run3 = false;")], True),
    ("runs of 1 plane", [("kRunPlanes = 32;", "kRunPlanes = 1;")], True),
    ("registers ptxas chooses", [("__global__ void __maxnreg__(kStagedRegs<TD>)",
                                  "__global__ void __launch_bounds__(288)")],
     True),
    ("X copied once", [(_X_COPY, "          if (j < kMarchStages) {\n" + _X_COPY
                        + "          }\n")], False),
    ("no sums", [("for (int r = 0; r < kRun3; ++r) {",
                  "for (int r = 0; r < 0; ++r) {")], False),
)
# --k8-variants: staged plans forced on this tree's kernel (name, fields)
K8_PLANS = (("units of 256 rows", {"tile_y": 256}),
            ("4 columns a stage", {"cols": 4}))
# --k8-forms: (n, 7-point, (data, X), the k timed)
K8_FORMS = (
    (200, False, ("bf16", "f32"), (1, 2, 3, 8, 12, 16)),
    (200, False, ("f32", "f32"), (1, 3, 4, 8, 16)),
    (200, False, ("f64", "f64"), (1, 3, 4)),
    (200, True, ("bf16", "f32"), (1, 8, 16)),
    (200, True, ("f32", "f32"), (1, 2, 8)),
    (200, True, ("f64", "f64"), (1, 2, 3, 8)),
    (100, False, ("bf16", "f32"), (1, 8, 16)),
    (100, False, ("f64", "f64"), (1, 3, 8)),
)
# --stencil-plans: (R, tz) forced beside the default plan
STENCIL_PLANS = ((1, 16), (1, 32), (2, 4), (2, 8), (2, 16), (4, 4), (4, 8),
                 (8, 2), (8, 4))
# --stencil-variants: (name, edits of csrc/stencil.cu, its result is right)
STENCIL_VARIANTS = (
    ("K2 unbounded", [("std::is_same<T, float>::value && R <= 2 ? 6 : 1;",
                       "1;")], True),
    ("K3 at five blocks an SM",
     [("__launch_bounds__(kThreads)\nstencil_axpy_apply_dots_kernel(",
       "__launch_bounds__(kThreads, 5)\nstencil_axpy_apply_dots_kernel(")],
     True),
)

# --vmem-variants: plans forced beside the default one (cg_plan's keywords:
# the march's R and tz, the ring's tz), and (name, edits
# of csrc/stencil_cg_vmem.cu, whether its sums run in this tree's order;
# None: a diagnostic whose results are wrong on purpose)
VMEM_PLANS = ({"form": "march"}, {"r": 2, "tz": 8},
              {"form": "ring", "tz": 15})
VMEM_VARIANTS = (
    ("phase B one value a load",
     [("const bool vec = aligned16(r)", "const bool vec = false && aligned16(r)")],
     False),
    ("four blocks an SM",
     [("__launch_bounds__(kThreads)\nstencil_cg_vmem_kernel(",
       "__launch_bounds__(kThreads, 4)\nstencil_cg_vmem_kernel(")], False),
    ("the ring at three blocks an SM",
     [("__launch_bounds__(kThreads)\nstencil_cg_vmem_kernel(",
       "__launch_bounds__(kThreads, kRing ? 3 : 1)\nstencil_cg_vmem_kernel(")],
     False),
    ("the ring at four blocks an SM",
     [("__launch_bounds__(kThreads)\nstencil_cg_vmem_kernel(",
       "__launch_bounds__(kThreads, kRing ? 4 : 1)\nstencil_cg_vmem_kernel(")],
     False),
    ("the ring without its sums",
     [("          if (x < 0) continue;",
       "          if (x < 0 || k >= 0) {\n"
       "            sum[m][0] = cen[m][0] = C(1);\n"
       "            out.pap = C(1e30);\n"
       "            continue;\n"
       "          }")],
     None),
)
# --vmem-variants: the phase split, each one edit of csrc/stencil_cg_vmem.cu
# (this tree's and, with --against, the other tree's): phase A alone (phase
# B's pass skipped, r.r held at one a thread, so every iteration runs) and
# phase B alone (phase A in the first iteration only, p'.w held at 1e30 a
# thread, so no iteration breaks down); each keeps both grid barriers and
# their sums, so barriers and sums take about A alone + B alone - whole
VMEM_PHASES = (
    ("phase A alone",
     [("    acc = C(0);\n    stream<C>(g.n, vec,",
       "    acc = C(1);\n    if (false) stream<C>(g.n, vec,")]),
    ("phase B alone",
     [("    OutA<C> out_a{p_new, w, C(0)};",
       "    OutA<C> out_a{p_new, w, C(k > 1 ? 1e30 : 0)};\n"
       "    if (k > 1) tiles = 0;")]),
)
VMEM_REPS = 3


def _best_wall(fn, reps: int = 3) -> float:
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return min(walls)


def _capture(fn, calls: int = 1):
    """(graph, last result): ``calls`` calls of ``fn()`` captured in one
    CUDA graph after a warm-up on a side stream, replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph, out


def replay_ms(fn, calls: int = 20) -> float:
    """Milliseconds per call of ``fn()``: the better of two replays of one
    CUDA graph of ``calls`` calls, timed with CUDA events."""
    graph, _ = _capture(fn, calls)
    best = float("inf")
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def operator(fmt: str, n: int, dev: torch.device):
    """(A, b, tag) of ``fmt`` at size n (module docstring)."""
    f32 = DTypePolicy.from_names("f32")
    if fmt == "rgl":
        A, _nnz = rgl_bslab(n, 512, 16.0, 1, device=dev, policy=f32,
                            impl="kernel")
        b = np.random.default_rng(0).standard_normal(n).astype(np.float32)
        return A, torch.from_numpy(b).to(dev), f"RGL {n}"
    A, counts = OPERATORS[fmt].from_stencil(n, n, n, device=dev, policy=f32,
                                           impl="kernel")
    _x, b, _xe = init_vectors(dtype=np.float32, row_lengths=counts)
    return A, torch.from_numpy(b).to(dev), f"{n}^3 {fmt}"


def solve_loop(solver: str, variant: str, A, b, itermax: int):
    """(run, graphable): one solve of ``solver`` from x = 0 as a callable
    that returns a result tensor, and whether the solve reads nothing on
    the host, so that a CUDA graph can capture it."""
    x0 = torch.zeros_like(b)
    eps = torch.tensor(0.0, device=b.device)
    if solver == "cg":
        loop = resolve_cg_loop(variant)
        graphable = variant in CG_LOOPS and variant != "vmem"
        return (lambda: loop(A, b, x0, itermax, eps)[2]), graphable
    if solver == "nrhs":
        B = b.repeat(NRHS, 1)  # (NRHS, n), slab-major
        X0 = torch.zeros_like(B)
        return (lambda: cg_multi_loop(A, B, X0, itermax, eps)[2]), True
    if solver == "gmres":
        def run():
            x = x0
            for _ in range(max(1, itermax // GMRES_RESTART)):
                x = gmres_cycle(A, b, x, GMRES_RESTART)[0]
            return x
        return run, False
    if solver == "cheb":
        lmin, lmax = estimate_bounds(A, A.nr, b.dtype)
        return (lambda: cheby_loop(A, b, x0, itermax, eps, lmin,
                                   lmax)[2]), True
    loop = {"bicgstab": bicgstab_loop, "minres": minres_loop}[solver]
    return (lambda: loop(A, b, x0, itermax, eps)[2]), True


def profile_size(n: int, itermax: int, fmt: str, variant: str,
                 gpu: str, solver: str = "cg") -> None:
    dev = torch.device("cuda")
    A, b, tag = operator(fmt, n, dev)
    run, graphable = solve_loop(solver, variant, A, b, itermax)
    what = {"cg": variant, "nrhs": f"cg --nrhs {NRHS}"}.get(solver, solver)
    tag = f"{tag}/{what} x{itermax}"

    run()
    torch.cuda.synchronize()
    wall = _best_wall(run)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        hist = run()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time for e in evs) * 1e-6
    ours = {}  # the registry's kernels (profiler.kernels), by device name
    for e in evs:
        if kernels_named(e.name):
            name = device_name(e.name)
            t, c = ours.get(name, (0.0, 0))
            ours[name] = (t + e.device_time * 1e-6, c + 1)
    own = sum(t for t, _c in ours.values())
    print(f"{tag}: wall {wall:.6f} s; device busy {busy:.6f} s "
          f"({busy / wall * 100:.1f} % of wall); port kernels {own:.6f} s "
          f"({own / busy * 100:.1f} % of device); "
          f"{len(evs) / itermax:.1f} device kernels per iteration | {gpu}")
    for name, (t, c) in sorted(ours.items()):
        ids = "/".join(k.id for k in kernels_named(name))
        print(f"    kernel {ids} {name}: {t:.6f} s device, {c} launches")
    by_name: dict = {}
    for e in evs:
        t, c = by_name.get(e.name[:90], (0.0, 0))
        by_name[e.name[:90]] = (t + e.device_time, c + 1)
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {t * 1e-3:10.3f} ms {c:6d}x  {name}")

    if not graphable:
        return
    graph, hist_g = _capture(run)  # the whole masked loop
    same = torch.equal(torch.nan_to_num(hist_g, nan=-1.0),
                       torch.nan_to_num(hist, nan=-1.0))
    print(f"{tag}: CUDA-graph replay {_best_wall(graph.replay):.6f}"
          f" s, history equal to eager: {same} | {gpu}")


def patterns(n: int, dev: torch.device):
    """(name, data, offsets) of ``--patterns`` at n^3 rows."""
    A, _ = DiaMatrix.from_stencil(n, n, n, device=dev, impl="kernel",
                                  policy=DTypePolicy.from_names("f32"))
    yield "stencil", A.data, A.offsets
    plane, row = n * n, n
    for name, offs in (
        ("one diagonal", (0,)),
        ("27 consecutive", tuple(range(-13, 14))),
        ("3 planes", (-plane, 0, plane)),
        ("9 rows of 3 planes", tuple(sz * plane + sy * row
                                     for sz in (-1, 0, 1)
                                     for sy in (-1, 0, 1))),
    ):
        yield name, torch.ones((len(offs), A.nr_pad), device=dev,
                               dtype=torch.bfloat16), offs


def profile_patterns(n: int, gpu: str) -> None:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = n ** 3
    for name, data, offs in patterns(n, dev):
        for k in PATTERN_KS:
            X = torch.randn((k, rows), generator=gen, device=dev)
            cols = [X[c] for c in range(k)]
            k8 = replay_ms(lambda: dia_spmm(data, X, offs, rows))
            k1 = replay_ms(lambda: [dia_spmv(data, x, offs, rows)
                                     for x in cols])
            nbytes = len(offs) * rows * 2 + 2 * k * rows * 4
            print(f"{n}^3 {name} ({len(offs)} diagonals) k={k}: K8 "
                  f"{k8:.4f} ms ({nbytes / (k8 * 1e-3) / 1e9:.0f} GB/s), "
                  f"{k} x K1 {k1:.4f} ms, K8 {k1 / k8:.2f}x faster | {gpu}")
            del X, cols
        del data
        torch.cuda.empty_cache()


def variant_trees(root, source: str, variants, tree: Path = None) -> list:
    """(name, tree, right) of each (name, edits, right) of ``variants``:
    this tree's (or ``tree``'s) csrc/<source> with the variant's edits and
    the shared headers, under ``root``."""
    from sparsebench_tpu_torch.ops import _build

    csrc_dir = (_build.CSRC_DIR if tree is None
                else tree / "sparsebench_tpu_torch" / "csrc")
    src = (csrc_dir / source).read_text()
    out = []
    for i, (name, edits, right) in enumerate(variants):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r} does not apply to "
                                 f"csrc/{source} ({old.strip()!r})")
            text = text.replace(old, new)
        csrc = root / f"v{i}" / "sparsebench_tpu_torch" / "csrc"
        csrc.mkdir(parents=True, exist_ok=True)
        for h in csrc_dir.glob("*.cuh"):
            (csrc / h.name).write_bytes(h.read_bytes())
        (csrc / source).write_text(text)
        out.append((name, root / f"v{i}", right))
    return out


def k8_as(plan, data, X, nr: int):
    """This tree's K8 under ``plan`` (``spmm_plan``'s, or one forced on it)
    on a contiguous, 16 B aligned (k, nr) X: Y."""
    from sparsebench_tpu_torch.ops import _build
    from sparsebench_tpu_torch.ops import dia_spmm as spmm_ops

    lib = spmm_ops._library()
    k = X.shape[0]
    Y = torch.empty((k, nr), dtype=X.dtype, device=X.device)
    err = getattr(lib, spmm_ops._ENTRY[(data.dtype, X.dtype)])(
        data.data_ptr(), X.data_ptr(), Y.data_ptr(), nr, data.shape[1], k,
        X.shape[1], nr, *spmm_ops.plan_args(plan, X.element_size()),
        torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(lib, err, "dia_spmm")
    return Y


def profile_k8_forms(sizes, gpu: str) -> None:
    """K8's staged form against its four-row form, in turns, at the inputs
    of ``K8_FORMS`` whose n is in ``sizes``."""
    from sparsebench_tpu_torch.ops.dia_spmm import spmm_plan, staged_plan

    dev = torch.device("cuda")
    dts = {"bf16": torch.bfloat16, "f32": torch.float32,
           "f64": torch.float64}
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, use_7pt, (td, tx), ks in K8_FORMS:
        if n not in sizes:
            continue
        A, _ = DiaMatrix.from_stencil(n, n, n, use_7pt=use_7pt, device=dev,
                                      impl="kernel",
                                      policy=DTypePolicy.from_names("f32"))
        d, offs, nr = A.data.to(dts[td]), A.offsets, A.nr
        tag = f"{n}^3 {7 if use_7pt else 27}-point {td}/{tx}"
        for k in ks:
            X = torch.randn((k, nr), device=dev, generator=gen).to(dts[tx])
            sizes_b = (d.element_size(), X.element_size())
            plan = spmm_plan(offs, nr, d.shape[1], nr, nr, True, k, sizes_b)
            staged = staged_plan(plan.chunks, nr, d.shape[1], k, sizes_b)
            if staged is None:
                print(f"{tag} k={k}: {plan.form}, no staged form | {gpu}")
                continue
            plans = {"quad": staged._replace(form="quad", windows=()),
                     "staged": staged}
            same = torch.equal(k8_as(plans["quad"], d, X, nr),
                               k8_as(staged, d, X, nr))
            if not same:
                raise SystemExit(f"K8's two forms differ at {tag} k={k}")
            ms = {"quad": [], "staged": []}
            for form in ("quad", "staged", "staged", "quad", "quad",
                         "staged"):
                ms[form].append(replay_ms(
                    lambda p=plans[form]: k8_as(p, d, X, nr)))
            q, st = min(ms["quad"]), min(ms["staged"])
            bound = (len(offs) * nr * d.element_size()
                     + 2 * k * nr * X.element_size()) / 3.35e9
            print(f"{tag} k={k}: {plan.form} picked; four-row "
                  f"{'/'.join(f'{t:.6f}' for t in ms['quad'])}, staged "
                  f"{'/'.join(f'{t:.6f}' for t in ms['staged'])} ms "
                  f"(units of {staged.rows} rows, {staged.cols} columns a "
                  f"stage): staged/four-row {st / q:.3f}; "
                  f"{bound / st:.3f} / {bound / q:.3f} of the bound "
                  f"{bound:.6f} ms | {gpu}", flush=True)
            del X
        del A, d
        torch.cuda.empty_cache()


def profile_k8_variants(n: int, gpu: str, against=None) -> None:
    """K8 at k = 8 on the n^3 stencil: this tree's beside its variants and,
    with ``against``, another tree's, in turns."""
    from sparsebench_tpu_torch.ops import _build
    from sparsebench_tpu_torch.ops.dia_spmm import spmm_plan
    from sparsebench_tpu_torch.profile_bslab import build_other, lib_k8

    dev = torch.device("cuda")
    A, _ = DiaMatrix.from_stencil(n, n, n, device=dev, impl="kernel",
                                  policy=DTypePolicy.from_names("f32"))
    d, offs, nr = A.data, A.offsets, A.nr
    X = torch.randn((NRHS, nr), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    fns = {"this tree": (lambda: dia_spmm(d, X, offs, nr), True)}
    plan = spmm_plan(offs, nr, d.shape[1], nr, nr, True, NRHS,
                     (d.element_size(), X.element_size()))
    for name, fields in K8_PLANS:
        fns[name] = (lambda p=plan._replace(**fields): k8_as(p, d, X, nr),
                     True)
    trees = variant_trees(_build.BUILD_DIR.parent / "k8_variants",
                          "dia_spmm.cu", K8_VARIANTS)
    if against is not None:
        trees.insert(0, ("the other tree", against, True))
    for name, tree, right in trees:
        lib = build_other(tree, "dia_spmm")
        fns[name] = (lambda lib=lib: lib_k8(lib, d, X, offs, nr), right)
    want = fns["this tree"][0]()
    for name, (fn, right) in fns.items():
        y = fn()
        if right and not torch.equal(y.view(torch.int32),
                                     want.view(torch.int32)):
            raise SystemExit(f"K8 {name} differs from this tree's at {n}^3")
        y.fill_(float("nan"))  # the next variant's output may reuse it
    order = list(fns) + list(fns)[::-1]
    ms = {name: [] for name in fns}
    for name in order:
        ms[name].append(replay_ms(fns[name][0]))
    bound = (len(offs) * nr * d.element_size() + 2 * NRHS * nr * 4) / 3.35e9
    this = min(ms["this tree"])
    for name, runs in ms.items():
        best = min(runs)
        print(f"{n}^3 k={NRHS} K8 {name}{'' if fns[name][1] else ' (wrong x)'}"
              f": {best:.6f} ms ({'/'.join(f'{t:.6f}' for t in runs)}), "
              f"{best / this:.3f}x this tree's, {bound / best:.3f} of the "
              f"bound {bound:.6f} ms | {gpu}", flush=True)
    del A, d, X
    torch.cuda.empty_cache()


def profile_stencil_plans(n: int, gpu: str, against=None,
                          variants: bool = False) -> None:
    """K2 and K3 on the n^3 grid under the default plan, each forced plan
    of ``STENCIL_PLANS`` and, with ``against``, another tree's kernels and,
    with ``variants``, those of ``STENCIL_VARIANTS``, in turns."""
    from sparsebench_tpu_torch.ops import _build
    from sparsebench_tpu_torch.ops import stencil as st
    from sparsebench_tpu_torch.profile_bslab import build_other, lib_k2, lib_k3

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x, r, p = (torch.randn(n ** 3, device=dev, generator=gen)
               for _ in range(3))
    beta = torch.tensor(0.5, device=dev)
    dims = (n, n, n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {"default": st.device_plan(x, *dims)}
    for rows, tz in STENCIL_PLANS:
        plans[f"R {rows} tz {tz}"] = st.tile_plan(*dims, 4, sms, r=rows,
                                                  tz=tz)
    want = (st.stencil_apply_torch(x, *dims),
            *st.stencil_axpy_apply_dots_torch(r, p, beta, *dims)[:2])
    fns = {}
    for name, plan in plans.items():
        fns[name] = (
            lambda plan=plan: st.stencil_apply(x, *dims, plan=plan),
            lambda plan=plan: st.stencil_axpy_apply_dots(r, p, beta, *dims,
                                                         plan=plan))
    trees = (variant_trees(_build.BUILD_DIR.parent / "stencil_variants",
                           "stencil.cu", STENCIL_VARIANTS) if variants else [])
    if against is not None:
        trees.insert(0, ("the other tree", against, True))
    for name, tree, _right in trees:
        lib = build_other(tree, "stencil")
        fns[name] = (lambda lib=lib: lib_k2(lib, x, *dims),
                     lambda lib=lib: lib_k3(lib, r, p, beta, *dims))
    for name, (k2, k3) in fns.items():
        got = (k2(), *k3()[:2])
        if not all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want)):
            raise SystemExit(f"K2/K3 {name} differs from the plain version "
                             f"at {n}^3")
    order = list(fns) + list(fns)[::-1]
    ms = {name: ([], []) for name in fns}
    for name in order:
        for j in range(2):
            ms[name][j].append(replay_ms(fns[name][j]))
    bounds = (2 * 4 * n ** 3 / 3.35e9, 4 * 4 * n ** 3 / 3.35e9)
    for name, (t2, t3) in ms.items():
        plan = plans.get(name)
        shape = (f"R {plan.r} tz {plan.tz}, grid {plan.grid}"
                 if plan is not None else "its own launch")
        print(f"{n}^3 f32 {name} ({shape}): K2 {min(t2):.6f} ms "
              f"({'/'.join(f'{t:.6f}' for t in t2)}), {bounds[0] / min(t2):.3f}"
              f" of the bound {bounds[0]:.6f} ms; K3 {min(t3):.6f} ms "
              f"({'/'.join(f'{t:.6f}' for t in t3)}), {bounds[1] / min(t3):.3f}"
              f" of the bound {bounds[1]:.6f} ms | {gpu}", flush=True)
    del x, r, p
    torch.cuda.empty_cache()


def event_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``reps`` back-to-back calls of ``fn``,
    timed with CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k5_bound_ms(n: int, iters: int, l2: int) -> float:
    """K5's bound at n^3, f32 (chip_smoke.py phase 5b's): the larger of
    the bytes (r0 and x0 read and x written once; each iteration the part
    of r, p and x beyond the L2 read and written) over 3.35 TB/s and the
    operations (38 a point an iteration, 2 a point once) over 67 TFLOP/s."""
    pts = n ** 3
    vecs = 3 * 4 * pts
    nbytes = vecs + iters * 2 * max(0, vecs - l2)
    return max(nbytes / 3.35e9, (2 + 38 * iters) * pts / 67e9)


def plan_shape(plan) -> str:
    """A K5 plan in a few words."""
    return (f"{plan.form} R {plan.r} tz {plan.tz}, {plan.tiles} tiles on "
            f"{plan.blocks} blocks")


def profile_vmem_variants(n: int, itermax: int, gpu: str,
                          against=None) -> None:
    """K5 on the n^3 problem: the default plan, the forced plans of
    ``VMEM_PLANS``, the variants of ``VMEM_VARIANTS`` and, with
    ``against``, another tree's K5, in turns."""
    from sparsebench_tpu_torch.ops import _build
    from sparsebench_tpu_torch.ops import stencil_cg_vmem as scv
    from sparsebench_tpu_torch.ops.stencil import stencil_apply
    from sparsebench_tpu_torch.profile_bslab import build_other, lib_k5

    dev = torch.device("cuda")
    dims = (n, n, n)
    A, counts = StencilOperator.from_stencil(*dims, device=dev)
    b = torch.from_numpy(27.0 - (counts - 1.0)).to(dev, torch.float32)
    x0 = torch.zeros_like(b)
    r0 = b - stencil_apply(x0, *dims)
    fns = {"this tree": (lambda: scv.stencil_cg_vmem(
        r0, x0, 0.0, *dims, itermax), True)}
    shapes = {"this tree": plan_shape(scv.device_cg_plan(r0, *dims))}
    for force in VMEM_PLANS:
        forced = scv.device_cg_plan(r0, *dims, **force)
        name = " ".join(f"{k} {v}" for k, v in force.items())
        shapes[name] = plan_shape(forced)
        fns[name] = (lambda forced=forced: scv.stencil_cg_vmem(
            r0, x0, 0.0, *dims, itermax, plan=forced), False)
    root = _build.BUILD_DIR.parent / "vmem_variants"
    phases = [(name, edits, None) for name, edits in VMEM_PHASES]
    trees = variant_trees(root, "stencil_cg_vmem.cu", VMEM_VARIANTS)
    trees += variant_trees(root / "phases", "stencil_cg_vmem.cu", phases)
    if against is not None:
        trees.insert(0, ("the other tree", against, False))
        trees += [(f"the other tree's {name}", tree, None) for name, tree, _
                  in variant_trees(root / "other", "stencil_cg_vmem.cu",
                                   phases, against)]
    for name, tree, same in trees:
        lib = build_other(tree, "stencil_cg_vmem")
        fns[name] = (lambda lib=lib: lib_k5(lib, r0, x0, 0.0, *dims, itermax),
                     same)
    x_ref, h_ref = fns["this tree"][0]()
    h_ref = h_ref.cpu().numpy()
    k_ref = int(np.sum(~np.isnan(h_ref)))
    sel = h_ref[:k_ref] >= 1e-4 * h_ref[0]
    for name, (fn, same) in fns.items():
        if same is None:  # a phase alone or a diagnostic: not CG's iterates
            continue
        x, h = fn()
        h = h.cpu().numpy()
        k = int(np.sum(~np.isnan(h)))
        ok = (k == k_ref and np.allclose(h[:k][sel], h_ref[:k][sel],
                                         rtol=1e-4, atol=0)
              and float((x - x_ref).abs().max()) <= 1e-4)
        if same:
            ok &= (np.array_equal(h.view(np.int32), h_ref.view(np.int32))
                   and torch.equal(x.view(torch.int32),
                                   x_ref.view(torch.int32)))
        if not ok:
            raise SystemExit(f"K5 {name} differs from this tree's at {n}^3")
    order = list(fns) + list(fns)[::-1]
    ms = {name: [] for name in fns}
    for name in order:
        ms[name].append(event_ms(fns[name][0], VMEM_REPS))
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    bound = k5_bound_ms(n, k_ref - 1, l2)
    this = min(ms["this tree"])
    for name, runs in ms.items():
        best = min(runs)
        shape = shapes.get(name, "its own plan")
        each = "/".join(f"{t:.6f}" for t in runs)
        print(f"{n}^3 f32 x{itermax} K5 {name} ({shape}): {best:.6f} ms "
              f"({each}), {best / this:.3f}x this tree's, {bound / best:.4f} "
              f"of the bound {bound:.6f} ms | {gpu}", flush=True)
    for tree, pre in (("this tree", ""), ("the other tree", "the other "
                                          "tree's ")):
        if f"{pre}phase A alone" not in ms:
            continue
        whole, a, b = (min(ms[k]) for k in (tree, f"{pre}phase A alone",
                                            f"{pre}phase B alone"))
        per = 1e3 / (k_ref - 1)
        print(f"{n}^3 f32 K5 phase split, {tree}, us an iteration over "
              f"{k_ref - 1}: whole {whole * per:.2f}; phase A alone "
              f"{a * per:.2f}, phase B alone {b * per:.2f} (each with both "
              f"barriers and sums); barriers and sums about "
              f"{(a + b - whole) * per:.2f}, so phase A {(whole - b) * per:.2f}"
              f" and phase B {(whole - a) * per:.2f} | {gpu}", flush=True)
    del A, b, x0, r0
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparsebench_tpu_torch.profile_cg")
    ap.add_argument("-n", type=int, nargs="+", default=[100, 200],
                    help="grid sizes (n^3), or rows for --fmt rgl; default "
                    "100 200")
    ap.add_argument("-i", type=int, default=150, dest="itermax",
                    help="CG iterations; default 150")
    ap.add_argument("--fmt", default="dia", choices=[*OPERATORS, "rgl"],
                    help="operator; default dia")
    ap.add_argument("--variant", default="standard", choices=CG_VARIANTS,
                    help="CG variant of --solver cg; default standard")
    ap.add_argument("--solver", default="cg", choices=SOLVERS,
                    help="solver; default cg")
    ap.add_argument("--patterns", action="store_true",
                    help="time K8 against k x K1 on diagonal patterns "
                    "(module docstring) instead of a solve")
    ap.add_argument("--k8-variants", action="store_true",
                    help="time K8 beside designs one edit away (module "
                    "docstring) instead of a solve")
    ap.add_argument("--k8-forms", action="store_true",
                    help="time K8's staged form against its four-row form "
                    "(module docstring) instead of a solve")
    ap.add_argument("--stencil-plans", action="store_true",
                    help="time K2 and K3 under forced tile plans (module "
                    "docstring) instead of a solve")
    ap.add_argument("--stencil-variants", action="store_true",
                    help="--stencil-plans, and K2 and K3 built one edit "
                    "away (module docstring) among them")
    ap.add_argument("--vmem-variants", action="store_true",
                    help="time K5 under forced plans and built one edit "
                    "away (module docstring) instead of a solve")
    ap.add_argument("--against", type=Path, default=None,
                    help="with --k8-variants, --stencil-plans or "
                    "--vmem-variants, another tree of this repository whose "
                    "K8, K2 and K3, or K5, to time in turns with this "
                    "tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_cg needs a CUDA card")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} | {gpu}")
    if args.k8_forms:
        profile_k8_forms(args.n, gpu)
        return 0
    for n in args.n:
        if args.k8_variants:
            profile_k8_variants(n, gpu, args.against)
        elif args.vmem_variants:
            profile_vmem_variants(n, args.itermax, gpu, args.against)
        elif args.stencil_plans or args.stencil_variants:
            profile_stencil_plans(n, gpu, args.against,
                                  args.stencil_variants)
        elif args.patterns:
            profile_patterns(n, gpu)
        else:
            profile_size(n, args.itermax, args.fmt, args.variant, gpu,
                         args.solver)
    return 0


if __name__ == "__main__":
    sys.exit(main())
