#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (sparsebench_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. fingerprint: nvidia-smi name and power limit, torch / CUDA / nvcc versions;
2. build: compile csrc/*.cu with nvcc for sm_90a, one nvcc per source, all
   started together (timed);
3. kernel against its plain version on the card: the DIA SpMV kernel (K1) vs
   dia_spmv_torch for (bf16, f32), (f32, f32) and (f64, f64) on the
   generated stencil at 10x9x7, 100^3 and 200^3, on
   tests/data/matrix_band_klein.mtx and on synthetic edge offsets;
3b. the stencil kernels against their plain versions: K2 (the apply, and
   its dots form) for the 27- and 7-point stencils in bf16, f32 and f64 at
   10x9x7, 100^3, 200^3 and edge shapes, the dots against their exact
   value to the bound of the kernels' summation; K3 and K4 on
   numpy-seeded random inputs; K5 (the whole CG solve in one launch) in
   f64 and f32 at 100^3;
3c. the bslab kernels K6 and K7 (windowed) against bslab_spmv_torch, bit
   for bit, for (bf16, f32), (f32, f32) and (f64, f64) on the generated
   stencil at 10x9x7, 100^3 and 200^3 (K7 where its window fits a block),
   klein and the small test matrices, RGL at 2M and RGL at 200k with one
   wide pool and with grouped pools;
4. main path: the CLI as a user runs it (``-t cg`` at 100^3, ``-f hpcg.par
   -t cg`` at 200^3, ``-t spmv``), with the kernel launch count set to 0
   before and read after those runs; then the f64 residual history at 100^3
   through the kernel against the plain version;
4b. the stencil path: ``--fmt stencil -t cg`` with each CG variant at 100^3
   and 200^3, ``cs`` with SB_FUSED_CS=1, and ``-t spmv --fmt stencil``,
   with every stencil kernel's launch count set to 0 before and read after;
   then K5 at 200^3 against stencil_cg_vmem_torch, the f64 history to rtol
   1e-9 above 1e-10 of the start;
4c. the bslab path: ``--fmt bslab -t cg`` at 100^3 and 200^3, ``--fmt sell
   -t cg`` at 100^3 (bridged to bslab), ``-m generateRGL`` at 2M with
   ``-t cg`` and ``-t spmv``, and ``-m <file> -t cg`` on a host RGL matrix
   of 100k rows written as .mtx (DIA refuses it, auto falls back to
   bslab), with the K6 and K7 counts set to 0 before and read after;
5. times: CG solve seconds and per-SpMV milliseconds of K1 and its plain
   version at 100^3 and 200^3, with physical GB/s, beside the same product
   as a cuSPARSE CSR SpMV (torch.sparse_csr_tensor @ x);
5b. times of K2-K5 (K5 at 100^3 and 200^3) beside their plain versions,
   their bounds and, for K2, torch.nn.functional.conv3d; CG x150 seconds of
   each stencil variant;
5c. times of K6 and K7 beside the plain version, their bounds, physical
   GB/s and cuSPARSE on the same matrix at 100^3, 200^3 and RGL 2M, and
   bslab CG x150 seconds on each;
3d. the multi-RHS DIA kernel K8 against dia_spmm_torch, bit for bit, and
   row c of its result against K1 on row c of the block, bit for bit, for
   k in {1, 2, 8, 9, 16}, (bf16, f32), (f32, f32) and (f64, f64), at
   10x9x7, 100^3, 200^3 and klein;
4d. the solver family through the CLI: ``-t cg --nrhs 8`` at 100^3 and
   ``-f hpcg.par -t cg --nrhs 8`` at 200^3 with the K8 count set to 0
   before and read after (at least 150 launches a solve); ``-t gmres``,
   ``cheb``, ``bicgstab`` and ``minres``, ``-t cg --precond
   jacobi|cheb|cheb-jacobi``, ``--cg-variant sstep|pipe``, ``--refine`` and
   ``--checkpoint`` at 100^3 with the K1 count read; then the f64 history
   through the kernels against the plain version for ``--nrhs 4`` and
   GMRES(10) at 40^3, and that f32 matrix products run without TF32;
5d. times: K8 at k = 8 (100^3 and 200^3) beside its bound, eight K1 calls,
   the plain version and cuSPARSE SpMM (torch.sparse.mm of the CSR matrix
   and an (n, 8) block made outside the timed region); blocked CG x150
   seconds for 8 right-hand sides, total and per right-hand side, beside
   one single-RHS solve; each new solver's seconds at 100^3;
3e. the read-ceiling kernel K12 against read_passes_torch, bit for bit, on
   ones (``out`` exact) and random data (``out`` and the sink's total within
   the bound of their f32 sums), at small and odd shapes and at the
   measurement's 256 MiB array;
4e. ``-t cg --profile`` at 100^3 and ``-f hpcg.par -t cg --profile`` at
   200^3 through the CLI (k = 150, the region table, a nonzero spMVM rate)
   with the K1 count set to 0 before and read after; ``--banner``;
5e. K12: the read ceiling ``measure_dma_read_gbps`` (the K12 count set to 0
   before it and read after: 8 launches), one launch per pass beside the
   plain version, torch.sum over the same array and the bound of a pass;
3f. the bsell kernels K9, K10 and K11 (both windowed) against
   bsell_spmv_torch, bit for bit, for (bf16, f32), (f32, f32) and (f64,
   f64) on the stencil through the host CSR (7x6x5, 20^3, 100^3) and on the
   device (10x9x7, 20x20x12, 100^3, 200^3), klein, the small test matrices
   and a random banded matrix of 50k rows; K10 and K11 where the window fits
   a block, their refusal checked where it does not;
4f. the bsell path: ``--fmt bsell -t cg`` at 100^3 with ``--impl`` auto
   (K9), kernel_win2 (K10), kernel_win (K11) and torch, then ``-t spmv``,
   with the K9-K11 counts set to 0 before and read after; the f64 residual
   lines of ``--impl kernel`` and ``--impl torch`` equal;
5f. times of K9-K11 at 100^3 (the CLI's host CSR build and the device
   build) and 200^3 (device build) beside their bounds, the plain version,
   cuSPARSE CSR f32 on the same matrix and K6 and K1 on the same problem,
   and bsell CG x150 seconds;
3g. the prototype kernels P1-P5 against their plain versions, bit for bit:
   P1's four schedules (dia_window: direct, grouped, qfloor, floor) and P2's
   two variants (dia_shear: roll, shear_chunk; tpc 2 and 3, so the last
   chunk is partial) with the real 200^3 shifts at the 200^3 extent (245
   tiles of 256 rows) and at small grids; P3's eight variants (slab_slices)
   with bf16 and f32 values at 1024 tiles x 54 slices; P4's four
   (slab_slices_tall) at SUB 8, 16, 32 and 64 in both dtypes; P5's pass 1
   (pass1_products) on RGL 2M and on the 8192- and 8000-row builds (the
   latter with phantom rows);
5g. the prototype modules as a user runs them (``python -m
   sparsebench_tpu_torch.benchmarks.<name>`` in-process, each at its full
   size: csr_twopass_proto on RGL 2M, dia_micro and dia_shear at 256 x 245,
   slab_micro and slab_micro2 at their defaults), with the P1-P5 counts set
   to 0 before and read after; then each kernel's per-call ms (graph replay)
   beside its plain version and bound at those shapes, with cuSPARSE CSR f32
   for P5's whole SpMV and for P1/P2's 27-diagonal product, and K1 at 200^3
   from phase 5 beside P1/P2;
6. ``python -m sparsebench_tpu_torch.bench``, the port's full bench suite, as
   a subprocess: rc 0 and a final JSON line of at most 1500 characters with
   a positive value, stream_read_GBps, dma_read_GBps, cg200_seconds and
   cg200_vmem_seconds; then ``python -m sparsebench_tpu_torch.bench spmv
   200 dia,bslab,bsell``, rc 0.

The phases run in the order 3-3g, 4-4f, 5-5g, 6. A bound is the larger of the bytes a call must
move (each input read once, each output written once) over 3.35 TB/s and
its operations over 67 TFLOP/s (f32), the H100 SXM's published rates at
700 W. The last three
lines are the card's name and power limit, a JSON object of the kernels and
the result line ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# f32 CG on the generated problem reaches max|x - 1| of about 1e-6 to 3e-6
# at 100^3 and 200^3 after 150 iterations (the JAX package reports the
# same); the CLI prints it with 6 decimals. Bound with headroom:
F32_DIFF_BOUND = 1e-5
# f64 CG at 100^3 drives the residual below 1e-10 of its start well
# before 150 iterations; max|x - 1| far below this bound
F64_DIFF_BOUND = 1e-8
# f64 history through a kernel vs the plain version: entries above the
# rounding-noise floor (1e-10 of the initial residual) agree to rtol 1e-9
NOISE_FLOOR = 1e-10
HIST_RTOL = 1e-9
SPMV_TIMING_REPS = 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, at 700 W
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
VARIANTS = ("standard", "cs", "fused", "vmem")
# operations a point, 27-point stencil: an apply is 26 adds, a multiply and
# a subtraction; K3 adds the p-update and the dot; one CG iteration (K5's
# work) is the p-update (2), one apply, p.Ap (2) and the r and x updates
# and r.r (6). K5 recomputes A p for its r update, a second apply that is
# its own design's cost and not counted in its bound.
APPLY_FLOPS = 28
K3_FLOPS = APPLY_FLOPS + 4
K4_FLOPS = 8
K5_FLOPS_PER_ITER = 2 + APPLY_FLOPS + 8
# The kernels' dots are per-thread products summed by a 256-wide block tree
# (8 levels), then torch.sum over the block partials: a tree over blocks
# after a short serial run per thread. A sum of n terms taken so has a
# forward error of at most (2 ceil(log2 n) + SUM_SERIAL) eps sum|terms|,
# with SUM_SERIAL a generous bound on the serial runs and the product's own
# rounding: about 1.3e-5 of sum|terms| at 200^3 in f32.
SUM_SERIAL = 64
# the read ceiling's array (measure_dma_read_gbps's default: 256 MiB, over
# 5 x the 50 MB L2) and the bench suite's own time limit
MEMROOF_FLOATS = 64 * 1024 * 1024
BENCH_TIMEOUT_S = 600


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_fingerprint() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def run_cli(main, argv):
    """Run the port's CLI in-process, echo its output, return the text."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    print(text, end="")
    check(rc == 0, f"cli {argv} returned {rc}")
    return text


def parse_cg(text: str):
    m = re.search(r"Solution performed (\d+) iterations and took", text)
    d = re.search(r"Difference between computed and exact\s+=\s+(\S+)", text)
    check(m is not None and d is not None, "CG output lines missing")
    return int(m.group(1)), float(d.group(1))


def time_call(fn, reps: int) -> float:
    """Milliseconds per call of ``fn()`` over ``reps`` back-to-back calls,
    timed with CUDA events after a warm-up."""
    import torch

    for _ in range(3):
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


def time_graph(fn, reps: int = 20) -> float:
    """Milliseconds per call of ``fn()`` replayed from one CUDA graph of
    ``reps`` calls, timed with CUDA events: the device's time without the
    host's launch cost, which at 100^3 exceeds a kernel's own."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, graph: bool = True, reps: int = SPMV_TIMING_REPS):
    """Kernel against plain version in turns (plain, kernel, kernel, plain),
    each by CUDA-graph replay (``graph``) or back-to-back eager calls.
    Returns (best kernel ms, best plain ms, all four, kernel eager ms)."""
    ms = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel if which == "kernel" else plain
        ms[which].append(time_graph(fn) if graph else time_call(fn, reps))
    eager = time_call(kernel, reps) if graph else min(ms["kernel"])
    return min(ms["kernel"]), min(ms["plain"]), ms, eager


def bound(nbytes: float, flops: float):
    """(least milliseconds, "bytes" or "operations") at the published
    rates."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def bits_equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.uint8
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def dots_check(got, terms, eps: float):
    """A kernel's dot ``got`` against the exact sum of ``terms`` (f64, the
    products the kernel rounds at precision ``eps`` and sums): returns
    (|got - exact|, the bound of the kernels' summation, exact). The exact
    sum is an f64 torch.sum for f32 products, whose own error is far below
    the bound, and math.fsum for f64 ones."""
    n = terms.numel()
    exact = (math.fsum(terms.cpu().numpy()) if eps < 1e-10
             else float(terms.sum()))
    tol = ((2 * math.ceil(math.log2(max(n, 2))) + SUM_SERIAL) * eps
           * float(terms.abs().sum()))
    return abs(float(got) - exact), tol, exact


def dia_to_csr(A):
    """The DIA matrix as a torch.sparse_csr_tensor with f32 values and
    int32 indices, built on the device (rows in order, columns ascending:
    the diagonals are sorted by offset), for the cuSPARSE yardstick."""
    import torch

    dev = A.data.device
    n = A.nr
    dt = A.data[:, :n].to(torch.float32).t()  # (n, ndiag)
    offs = torch.tensor(A.offsets, dtype=torch.int64, device=dev)
    cols = torch.arange(n, device=dev).unsqueeze(1) + offs
    mask = (dt != 0) & (cols >= 0) & (cols < A.nc)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(mask.sum(1), 0)
    return torch.sparse_csr_tensor(crow, cols[mask].to(torch.int32),
                                   dt[mask], (n, A.nc),
                                   check_invariants=False)


def phase3_dia(dev):
    """K1 against dia_spmv_torch; returns the largest |kernel - plain|."""
    import torch

    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.dia import DiaMatrix
    from sparsebench_tpu_torch.host import read_mm
    from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_torch

    # The kernel rounds every product and sum (no FMA contraction) and sums
    # the diagonals in the plain version's order, so the two are expected
    # to agree bit for bit. The stated tolerance is the forward error bound
    # of any ordering of an ndiag-term sum with or without contraction:
    # |y_kernel - y_plain| <= ndiag * eps(x dtype) * (|A| |x|)_i.
    f32 = DTypePolicy.from_names("f32")
    f64 = DTypePolicy.from_names("f64")
    pairs = [(torch.bfloat16, torch.float32), (torch.float32, torch.float32),
             (torch.float64, torch.float64)]
    cases = []
    for dims in [(10, 9, 7), (100, 100, 100), (200, 200, 200)]:
        A, _ = DiaMatrix.from_stencil(*dims, device=dev, policy=f32,
                                      impl="kernel")
        cases.append((f"stencil {dims[0]}x{dims[1]}x{dims[2]}", A.data,
                      A.offsets, A.nr))
    klein = read_mm(str(REPO / "tests" / "data" / "matrix_band_klein.mtx"))
    A = DiaMatrix.from_csr(klein, f64, device=dev, impl="kernel",
                           compress=False)
    cases.append(("matrix_band_klein.mtx", A.data, A.offsets, A.nr))
    gen = torch.Generator(device=dev).manual_seed(0)
    for offsets, nr in [((-1000, -1, 0, 1, 999), 128 * 64),
                        ((-257, 0, 257), 5000), ((0,), 1), ((-3, 5), 7)]:
        data = torch.randn((len(offsets), max(128, nr)), generator=gen,
                           device=dev, dtype=torch.float64)
        cases.append((f"synthetic offsets {offsets} nr={nr}", data,
                      offsets, nr))
    max_err = 0.0
    for name, data0, offsets, nr in cases:
        for td, tx in pairs:
            data = data0.to(td)
            x = torch.randn(nr, generator=gen, device=dev, dtype=torch.float64)
            x = x.to(tx)
            before = dia_spmv.launches
            y_k = dia_spmv(data, x, offsets, nr)
            check(dia_spmv.launches == before + 1,
                  "launch counter did not count the launch")
            y_p = dia_spmv_torch(data, x, offsets, nr)
            bnd = dia_spmv_torch(data.abs(), x.abs(), offsets, nr)
            torch.cuda.synchronize()
            tol = len(offsets) * torch.finfo(tx).eps
            err = (y_k - y_p).abs()
            ok = bool(torch.isfinite(y_k).all()) and bool(
                (err <= tol * bnd).all())
            e = float(err.max())
            max_err = max(max_err, e)
            td_name = str(td).removeprefix("torch.")
            tx_name = str(tx).removeprefix("torch.")
            print(f"[3 kernel] {name} data {td_name} x {tx_name}: "
                  f"max|kernel-plain| {e:.3e} (bound {tol:.2e}*(|A||x|)_i)"
                  f" {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with the plain version on {name}")
    return max_err


def phase3b_stencil(dev):
    """K2-K5 against their plain versions; returns ({kernel: max |err| of
    its elementwise outputs (K5: of x)}, {kernel: max relative error of its
    dots})."""
    import torch

    from sparsebench_tpu_torch.formats.stencil import StencilOperator
    from sparsebench_tpu_torch.ops.cg_fused import cs_update, cs_update_torch
    from sparsebench_tpu_torch.ops.stencil import (
        stencil_apply,
        stencil_apply_dots,
        stencil_apply_dots_torch,
        stencil_apply_torch,
        stencil_axpy_apply_dots,
        stencil_axpy_apply_dots_torch,
    )
    from sparsebench_tpu_torch.ops.stencil_cg_vmem import (
        stencil_cg_vmem,
        stencil_cg_vmem_torch,
    )

    dts = {"bf16": torch.bfloat16, "f32": torch.float32,
           "f64": torch.float64}
    rng = np.random.default_rng(2024)

    def rand(n, dt):
        return torch.from_numpy(rng.standard_normal(n)).to(dev, dts[dt])

    err = {"K2": 0.0, "K3": 0.0, "K4": 0.0, "K5": 0.0}
    dots_rel = {"K2": 0.0, "K3": 0.0}
    eps32 = torch.finfo(torch.float32).eps
    # K2: the apply bit for bit; the dots (f32 for every vector type) to
    # the summation bound of ``dots_check`` around their exact value
    shapes = [(10, 9, 7), (100, 100, 100), (200, 200, 200), (1, 1, 1),
              (130, 2, 3), (128, 5, 4), (1, 5, 6)]
    for dims in shapes:
        n = dims[0] * dims[1] * dims[2]
        for use_7pt in (False, True):
            for dt in dts:
                x = rand(n, dt)
                y = stencil_apply(x, *dims, use_7pt)
                y_ref = stencil_apply_torch(x, *dims, use_7pt)
                yd, gd = stencil_apply_dots(x, *dims, use_7pt)
                yd_ref, _gd_ref = stencil_apply_dots_torch(x, *dims, use_7pt)
                torch.cuda.synchronize()
                same = bits_equal(y, y_ref) and bits_equal(yd, yd_ref)
                # the f32 values the kernel multiplies: x, and A x at the
                # compute width before a bf16 store rounds it
                xf = x.float().double()
                ycomp = stencil_apply_torch(
                    x.to(torch.float32 if dt != "f64" else torch.float64),
                    *dims, use_7pt).float().double()
                ok_dots, line = True, []
                for got, terms in ((gd[0], xf * xf), (gd[1], ycomp * xf)):
                    e, tol, exact = dots_check(got, terms, eps32)
                    ok_dots &= e <= tol
                    dots_rel["K2"] = max(dots_rel["K2"],
                                         e / max(abs(exact), 1e-30))
                    line.append(f"{e:.3e} (bound {tol:.3e})")
                err["K2"] = max(err["K2"], float(
                    (y.double() - y_ref.double()).abs().max()))
                name = (f"{dims[0]}x{dims[1]}x{dims[2]} "
                        f"{'7' if use_7pt else '27'}-pt {dt}")
                print(f"[3b K2] {name}: apply bit-identical {same}; dots "
                      f"|err| vs exact {', '.join(line)} "
                      f"{'ok' if same and ok_dots else 'FAIL'}")
                check(same and ok_dots, f"K2 disagrees on {name}")
    # K3: p' and w bit for bit, delta (at the compute width) to the
    # summation bound around its exact value
    for dims in [(10, 9, 7), (100, 100, 100), (200, 200, 200)]:
        n = dims[0] * dims[1] * dims[2]
        for dt in dts:
            r, p = rand(n, dt), rand(n, dt)
            beta = torch.tensor(float(rng.uniform(0.1, 2.0)), device=dev)
            pn, w, d = stencil_axpy_apply_dots(r, p, beta, *dims)
            pn_r, w_r, _d_r = stencil_axpy_apply_dots_torch(r, p, beta,
                                                            *dims)
            same = bits_equal(pn, pn_r) and bits_equal(w, w_r)
            # p' and w at the compute width, before a bf16 store
            cdt = d.dtype
            pn_c, w_c, _ = stencil_axpy_apply_dots_torch(
                r.to(cdt), p.to(cdt), beta, *dims)
            e, tol, exact = dots_check(d, (w_c * pn_c).double(),
                                       torch.finfo(cdt).eps)
            ok = same and e <= tol
            err["K3"] = max(err["K3"], float(
                (w.double() - w_r.double()).abs().max()), float(
                (pn.double() - pn_r.double()).abs().max()))
            dots_rel["K3"] = max(dots_rel["K3"], e / max(abs(exact), 1e-30))
            print(f"[3b K3] {dims[0]}x{dims[1]}x{dims[2]} {dt}: p', w "
                  f"bit-identical {same}; |delta - exact| {e:.3e} (bound "
                  f"{tol:.3e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K3 disagrees at {dims} {dt}")
    # K4: all four outputs bit for bit, any length
    for n in (1, 1000, 10**6, 8 * 10**6):
        for dt in dts:
            vecs = [rand(n, dt) for _ in range(6)]
            al = torch.tensor(float(rng.uniform(-1, 1)), device=dev)
            be = torch.tensor(float(rng.uniform(0, 2)), device=dev)
            got = cs_update(*vecs, al, be)
            want = cs_update_torch(*vecs, al, be)
            same = all(bits_equal(g, w) for g, w in zip(got, want))
            err["K4"] = max([err["K4"]] + [
                float((g.double() - w.double()).abs().max())
                for g, w in zip(got, want)])
            print(f"[3b K4] n={n} {dt}: bit-identical {same} "
                  f"{'ok' if same else 'FAIL'}")
            check(same, f"K4 disagrees at n={n} {dt}")
    # K5 at 100^3 from the same r0 and x0: k equal and the history to its
    # rtol above its floor, x to its atol (the sums run in another order).
    # f64: rtol 1e-9 above 1e-10 of the start, x to 1e-10; f32 (the float
    # instantiation the main path runs): rtol 1e-4 above 1e-4, x to 1e-4.
    A, counts = StencilOperator.from_stencil(100, 100, 100, device=dev)
    for dt, floor, rtol, atol in (("f64", NOISE_FLOOR, HIST_RTOL, 1e-10),
                                  ("f32", 1e-4, 1e-4, 1e-4)):
        b = torch.from_numpy(27.0 - (counts - 1.0)).to(dev, dts[dt])
        x0 = torch.zeros_like(b)
        r0 = b - A.spmv(x0)
        x_k, h_k = stencil_cg_vmem(r0, x0, 0.0, 100, 100, 100, 150)
        x_p, h_p = stencil_cg_vmem_torch(r0, x0, 0.0, 100, 100, 100, 150)
        h_k, h_p = h_k.cpu().numpy(), h_p.cpu().numpy()
        k_k, k_p = int(np.sum(~np.isnan(h_k))), int(np.sum(~np.isnan(h_p)))
        sel = h_p[:k_p] >= floor * h_p[0]
        rel = float(np.max(np.abs(h_k[:k_p][sel] - h_p[:k_p][sel])
                           / h_p[:k_p][sel]))
        ex = float((x_k - x_p).abs().max())
        err["K5"] = max(err["K5"], ex)
        ok = (k_k == k_p and rel <= rtol and ex <= atol
              and bool(torch.isfinite(x_k).all()))
        print(f"[3b K5] 100^3 {dt} x150: k {k_k} vs plain {k_p}; "
              f"{int(sel.sum())} history entries above {floor} of the start,"
              f" max rel diff {rel:.3e} (rtol {rtol}); max|x_kernel - "
              f"x_plain| {ex:.3e} (atol {atol}); max|x-1| "
              f"{float((x_k - 1).abs().max()):.3e} {'ok' if ok else 'FAIL'}")
        check(ok, f"K5 disagrees with its plain version in {dt}")
    return err, dots_rel


def phase4b_stencil(cli, gpu):
    """The stencil path through the CLI; returns {kernel: launches}."""
    from sparsebench_tpu_torch.ops.cg_fused import cs_update
    from sparsebench_tpu_torch.ops.stencil import (
        stencil_apply,
        stencil_apply_dots,
        stencil_axpy_apply_dots,
    )
    from sparsebench_tpu_torch.ops.stencil_cg_vmem import stencil_cg_vmem

    wrappers = {"K2": stencil_apply, "K2 dots": stencil_apply_dots,
                "K3": stencil_axpy_apply_dots, "K4": cs_update,
                "K5": stencil_cg_vmem}
    for w in wrappers.values():
        w.launches = 0
    runs = [(n, v, False) for n in (100, 200) for v in VARIANTS] + [
        (100, "cs", True)]
    for n, variant, fused_cs in runs:
        size = [] if n == 100 else ["-f", str(REPO / "hpcg.par")]
        argv = [*size, "-t", "cg", "--fmt", "stencil", "--cg-variant",
                variant]
        before = {k: w.launches for k, w in wrappers.items()}
        if fused_cs:
            os.environ["SB_FUSED_CS"] = "1"
        try:
            text = run_cli(cli.main, argv)
        finally:
            os.environ.pop("SB_FUSED_CS", None)
        k, diff = parse_cg(text)
        ran = {key: w.launches - before[key] for key, w in wrappers.items()}
        label = variant + (" SB_FUSED_CS=1" if fused_cs else "")
        print(f"[4b stencil] {n}^3 {label}: k={k} difference={diff} "
              f"launches {ran} | {gpu}")
        check(k == 150, f"{argv}: k={k}, expected 150")
        check(diff < F32_DIFF_BOUND, f"{argv}: difference {diff}")
        # warm-up + timed solve: r0 and 149 bodies each
        need = {"standard": {"K2": 2 * 150}, "cs": {"K2": 2 * 150},
                "fused": {"K2": 2, "K3": 2 * 149},
                "vmem": {"K2": 2, "K5": 2}}[variant]
        if fused_cs:
            need = {"K2": 2, "K2 dots": 2 * 150, "K4": 2 * 149}
        for key, want in need.items():
            check(ran[key] >= want, f"{argv}: {key} launched {ran[key]} "
                  f"times, expected {want}")
        if variant == "vmem":
            check(ran["K5"] == 2, "K5: one launch per solve expected")
    before = stencil_apply.launches
    text = run_cli(cli.main, ["-t", "spmv", "--fmt", "stencil"])
    n = stencil_apply.launches - before
    m = re.search(r"spMVM best per-iteration time: (\S+) ms", text)
    check(m is not None and n >= 150, f"-t spmv --fmt stencil: {n} launches")
    print(f"[4b stencil] -t spmv --fmt stencil: K2 launches={n}, reported "
          f"per-apply time {m.group(1)} ms | {gpu}")
    launches = {key: w.launches for key, w in wrappers.items()}
    print(f"[4b stencil] launches over the stencil path: {launches}")
    for key, count in launches.items():
        check(count > 0, f"{key} was not launched on the stencil path")
    vmem200_history()
    return launches


def vmem200_history() -> None:
    """K5 at 200^3 (r and p stream from device memory there) against its
    plain version from the same r0 and x0: k equal and the history to rtol
    1e-9 above 1e-10 of the start in f64, x to 1e-10."""
    import torch

    from sparsebench_tpu_torch.formats.stencil import StencilOperator
    from sparsebench_tpu_torch.ops.stencil_cg_vmem import (
        stencil_cg_vmem,
        stencil_cg_vmem_torch,
    )

    dev = torch.device("cuda")
    A, counts = StencilOperator.from_stencil(200, 200, 200, device=dev)
    b = torch.from_numpy(27.0 - (counts - 1.0)).to(dev, torch.float64)
    x0 = torch.zeros_like(b)
    r0 = b - A.spmv(x0)
    x_k, h_k = stencil_cg_vmem(r0, x0, 0.0, 200, 200, 200, 150)
    x_p, h_p = stencil_cg_vmem_torch(r0, x0, 0.0, 200, 200, 200, 150)
    h_k, h_p = h_k.cpu().numpy(), h_p.cpu().numpy()
    k_k, k_p = int(np.sum(~np.isnan(h_k))), int(np.sum(~np.isnan(h_p)))
    sel = h_p[:k_p] >= NOISE_FLOOR * h_p[0]
    rel = float(np.max(np.abs(h_k[:k_p][sel] - h_p[:k_p][sel])
                       / h_p[:k_p][sel]))
    ex = float((x_k - x_p).abs().max())
    ok = (k_k == k_p == 150 and rel <= HIST_RTOL and ex <= 1e-10
          and bool(torch.isfinite(x_k).all()))
    print(f"[4b stencil] K5 200^3 f64 x150: k {k_k} vs plain {k_p}; "
          f"{int(sel.sum())} history entries above {NOISE_FLOOR} of the "
          f"start, max rel diff {rel:.3e} (rtol {HIST_RTOL}); max|x_kernel - "
          f"x_plain| {ex:.3e}; max|x-1| {float((x_k - 1).abs().max()):.3e} "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "K5 at 200^3 disagrees with its plain version in f64")


def stencil_cg_seconds(dev, gpu) -> None:
    """CG x150 solve seconds (solve_cg's timed solve after its warm-up) of
    each stencil variant at 100^3 and 200^3, f32, through the kernels."""
    from sparsebench_tpu_torch.formats.stencil import StencilOperator
    from sparsebench_tpu_torch.solvers.cg import init_vectors, solve_cg

    for n in (100, 200):
        A, counts = StencilOperator.from_stencil(n, n, n, device=dev)
        _x0, b, xexact = init_vectors(dtype=np.float32, row_lengths=counts)
        for variant, fused_cs in [(v, False) for v in VARIANTS] + [
                ("cs", True)]:
            if fused_cs:
                os.environ["SB_FUSED_CS"] = "1"
            try:
                res = solve_cg(A, b, itermax=150, verbose=False,
                               variant=variant)
            finally:
                os.environ.pop("SB_FUSED_CS", None)
            diff = float(np.max(np.abs(res.x - xexact)))
            label = variant + (" SB_FUSED_CS=1" if fused_cs else "")
            print(f"[5b times] {n}^3 f32 --fmt stencil CG x150 {label}: "
                  f"{res.solve_seconds:.6f} s (k={res.iterations}, "
                  f"max|x-1| {diff:.3e}) | {gpu}")
            check(res.iterations == 150 and diff < F32_DIFF_BOUND,
                  f"{n}^3 {label}: k={res.iterations}, max|x-1| {diff}")


def phase5b_times(dev, gpu):
    """Per-call ms of K2-K5, their plain versions, bounds and library
    calls; returns {kernel: {...}}."""
    import torch
    import torch.nn.functional as F

    from sparsebench_tpu_torch.formats.stencil import stencil_row_counts
    from sparsebench_tpu_torch.ops.cg_fused import cs_update, cs_update_torch
    from sparsebench_tpu_torch.ops.stencil import (
        stencil_apply,
        stencil_apply_torch,
        stencil_axpy_apply_dots,
        stencil_axpy_apply_dots_torch,
    )
    from sparsebench_tpu_torch.ops.stencil_cg_vmem import (
        stencil_cg_vmem,
        stencil_cg_vmem_torch,
    )

    out = {"K2": {}, "K3": {}, "K4": {}, "K5": {}}
    rng = np.random.default_rng(7)
    torch.backends.cudnn.allow_tf32 = False  # the conv3d yardstick in f32
    for n in (100, 200):
        pts = n ** 3
        dims = (n, n, n)
        vec = lambda: torch.from_numpy(  # noqa: E731
            rng.standard_normal(pts).astype(np.float32)).to(dev)
        x, r, p = vec(), vec(), vec()
        beta = torch.tensor(0.5, device=dev)
        # K2 and conv3d with the same 27-point weight, zero padding
        weight = -torch.ones((1, 1, 3, 3, 3), device=dev)
        weight[0, 0, 1, 1, 1] = 27.0
        x5 = x.view(1, 1, n, n, n)
        lib = min(time_graph(lambda: F.conv3d(x5, weight, padding=1))
                  for _ in range(2))
        conv_err = float((F.conv3d(x5, weight, padding=1).reshape(-1)
                          - stencil_apply(x, *dims)).abs().max())
        k_ms, p_ms, all_ms, eager = time_pair(
            lambda: stencil_apply(x, *dims),
            lambda: stencil_apply_torch(x, *dims))
        b_ms, b_by = bound(2 * 4 * pts, APPLY_FLOPS * pts)
        out["K2"][n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib, eager_ms=eager)
        print(f"[5b times] K2 apply {n}^3 f32: kernel {all_ms['kernel']} ms, "
              f"plain {all_ms['plain']} ms (graph replay), kernel eager "
              f"{eager:.6f} ms, conv3d (cuDNN, TF32 off) "
              f"{lib:.6f} ms (max|conv3d - kernel| {conv_err:.3e}); bound "
              f"{b_ms:.6f} ms ({b_by}) | {gpu}")
        k_ms, p_ms, all_ms, eager = time_pair(
            lambda: stencil_axpy_apply_dots(r, p, beta, *dims),
            lambda: stencil_axpy_apply_dots_torch(r, p, beta, *dims))
        b_ms, b_by = bound(4 * 4 * pts, K3_FLOPS * pts)
        out["K3"][n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None, eager_ms=eager)
        print(f"[5b times] K3 axpy+apply+dot {n}^3 f32: kernel "
              f"{all_ms['kernel']} ms, plain {all_ms['plain']} ms (graph "
              f"replay), kernel eager {eager:.6f} ms; bound "
              f"{b_ms:.6f} ms ({b_by}) | {gpu}")
        vecs = [vec() for _ in range(6)]
        al = torch.tensor(0.3, device=dev)
        k_ms, p_ms, all_ms, eager = time_pair(
            lambda: cs_update(*vecs, al, beta),
            lambda: cs_update_torch(*vecs, al, beta))
        b_ms, b_by = bound(10 * 4 * pts, K4_FLOPS * pts)
        out["K4"][n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None, eager_ms=eager)
        print(f"[5b times] K4 cs update {n}^3 f32: kernel {all_ms['kernel']}"
              f" ms, plain {all_ms['plain']} ms (graph replay), kernel eager "
              f"{eager:.6f} ms; bound {b_ms:.6f} ms "
              f"({b_by}) | {gpu}")
        del x, r, p, vecs, x5
    # K5: one whole solve in f32, 150 iterations (at 200^3 r and p stream
    # from device memory)
    for n in (100, 200):
        b = torch.from_numpy((27.0 - (stencil_row_counts(n, n, n) - 1.0))
                             .astype(np.float32)).to(dev)
        x0 = torch.zeros_like(b)
        r0 = b - stencil_apply(x0, n, n, n)
        _x, hist = stencil_cg_vmem(r0, x0, 0.0, n, n, n, 150)
        iters = int(torch.sum(~torch.isnan(hist))) - 1
        # eager: the plain version reads scalars on the host each
        # iteration, and one launch of the kernel takes milliseconds
        k_ms, p_ms, all_ms, eager = time_pair(
            lambda: stencil_cg_vmem(r0, x0, 0.0, n, n, n, 150),
            lambda: stencil_cg_vmem_torch(r0, x0, 0.0, n, n, n, 150),
            graph=False, reps=3)
        pts = n ** 3
        b_ms, b_by = bound(3 * 4 * pts, (2 + K5_FLOPS_PER_ITER * iters) * pts)
        out["K5"][n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None, eager_ms=eager)
        print(f"[5b times] K5 whole CG solve {n}^3 f32 x150 ({iters} "
              f"iterations run): kernel {all_ms['kernel']} ms, plain "
              f"{all_ms['plain']} ms; bound {b_ms:.6f} ms ({b_by}: r0 and x0 "
              f"read, x written once; {K5_FLOPS_PER_ITER} flops a point an "
              f"iteration) | {gpu}")
        del b, x0, r0, _x, hist
    return out


# -- K6 and K7: the bslab SpMV -------------------------------------------------

RGL_N = 2_000_000  # the size of the README's generateRGL command
RGL_ARGS = ["-m", "generateRGL", "-x", str(RGL_N), "-y", "1", "-z", "1",
            "--band", "512", "--deg", "16", "--seed", "1"]
BSLAB_PAIRS = (("bf16", "f32"), ("f32", "f32"), ("f64", "f64"))


def bslab_matrices(dev):
    """(name, BslabMatrix) of phase 3c, built one at a time with the f32
    policy (bf16 values where lossless): the generated stencil at 10x9x7,
    100^3 and 200^3, klein and the small test matrices, RGL at 2M with the
    default layout, and RGL at 200k with one wide pool and with grouped
    pools of span 3."""
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.bslab import BslabMatrix
    from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab
    from sparsebench_tpu_torch.host import read_mm

    f32 = DTypePolicy.from_names("f32")
    for dims in [(10, 9, 7), (100, 100, 100), (200, 200, 200)]:
        yield (f"stencil {dims[0]}x{dims[1]}x{dims[2]}",
               BslabMatrix.from_stencil(*dims, device=dev, policy=f32)[0])
    data = REPO / "tests" / "data"
    files = [data / "matrix_band_klein.mtx"] + sorted(
        (data / "testMatrices").glob("test*.mtx"))
    for path in files:
        yield path.name, BslabMatrix.from_csr(read_mm(str(path)), f32,
                                              device=dev)
    yield "RGL 2M", rgl_bslab(RGL_N, 512, 16.0, 1, device=dev, policy=f32)[0]
    for name, opts in (("one wide pool", dict(force_caps=(1,) * 9)),
                       ("pools of span 3", dict(force_caps=(2,) * 9,
                                                force_span=3))):
        yield (f"RGL 200k {name}",
               rgl_bslab(200_000, 512, 16.0, 1, device=dev, policy=f32,
                         **opts)[0])


def slices_as(A, td):
    sl = A.slices
    return sl._replace(vals_aff=sl.vals_aff.to(td), vals_gen=sl.vals_gen.to(td),
                       vals_wide=sl.vals_wide.to(td))


def phase3c_bslab(dev):
    """K6 and K7 against bslab_spmv_torch, bit for bit, in all three
    (values, x) pairs; K7 wherever its window fits. Returns ({kernel: max
    |kernel - plain|}, {case: the impl auto picked})."""
    import torch

    from sparsebench_tpu_torch.ops.bslab_spmv import (
        bslab_spmv,
        bslab_spmv_torch,
        bslab_spmv_win,
        win_fits,
        win_smem_bytes,
    )

    dts = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
    rng = np.random.default_rng(31)
    err = {"K6": 0.0, "K7": 0.0}
    auto = {}
    k7_cases = 0
    for name, A in bslab_matrices(dev):
        auto[name] = A.impl
        x0 = rng.standard_normal(A.nc)
        for td, tx in BSLAB_PAIRS:
            sl = slices_as(A, dts[td])
            x = torch.from_numpy(x0).to(dev, dts[tx])
            y_p = bslab_spmv_torch(sl, x, sub=A.sub, lead=A.lead,
                                   x_rows=A.x_rows)
            y_k = bslab_spmv(sl, x, sub=A.sub, lead=A.lead)
            torch.cuda.synchronize()
            same = bits_equal(y_k, y_p) and bool(torch.isfinite(y_k).all())
            err["K6"] = max(err["K6"], float((y_k - y_p).abs().max()))
            line = f"K6 bit-identical {same}"
            ok = same
            if win_fits(sl, A.w_blocks, x.dtype):
                y_w = bslab_spmv_win(A.wchunk, sl, x, sub=A.sub, lead=A.lead,
                                     w_blocks=A.w_blocks)
                torch.cuda.synchronize()
                same_w = bits_equal(y_w, y_p)
                err["K7"] = max(err["K7"], float((y_w - y_p).abs().max()))
                line += f"; K7 bit-identical {same_w}"
                ok &= same_w
                k7_cases += 1
            else:
                need = win_smem_bytes(sl, A.w_blocks, x.dtype)
                line += f"; K7 window {need} B does not fit a block"
            print(f"[3c bslab] {name} (sub {A.sub}, slices {A.s_aff}/{A.s_gen}"
                  f"/{A.s_wide}, W {A.w_blocks}, auto {A.impl}) values {td} x "
                  f"{tx}: {line} {'ok' if ok else 'FAIL'}")
            check(ok, f"K6/K7 disagree with the plain version on {name} "
                  f"{td}/{tx}")
            del sl, x, y_p, y_k
        del A
        torch.cuda.empty_cache()
    check(k7_cases > 0, "K7 was compared on no case")
    return err, auto


def bslab_cli_checks(cli, argv, gpu, wrappers, need):
    """One CLI run of the bslab path; returns (text, {kernel: launches})."""
    before = {k: w.launches for k, w in wrappers.items()}
    text = run_cli(cli.main, argv)
    ran = {k: w.launches - before[k] for k, w in wrappers.items()}
    for key, want in need.items():
        check(ran[key] >= want, f"{argv}: {key} launched {ran[key]} times, "
              f"expected at least {want}")
    return text, ran


def write_rgl_mtx(path: Path, n: int) -> None:
    """The host RGL matrix (band 512, deg 16, seed 1) as a Matrix Market
    file, 1025 diagonals, far past DIA's limit. Its diagonal is raised by
    (i mod 7) / 4: the RGL matrix's rows all sum to 1, so b = 1 would be an
    eigenvector and CG would stop after one step."""
    from sparsebench_tpu_torch.host import rgl_csr

    csr = rgl_csr(n, band=512, deg=16.0, seed=1)
    rows = np.repeat(np.arange(n), csr.row_lengths)
    val = csr.val + np.where(csr.col == rows, (rows % 7) * 0.25, 0.0)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n} {n} {csr.nnz}\n")
        np.savetxt(f, np.column_stack([rows + 1, csr.col + 1, val]),
                   fmt="%d %d %.2f")


def phase4c_bslab(cli, gpu, tmpdir: Path, auto_kernel: str):
    """The bslab path through the CLI with the K6 and K7 counts set to 0
    before and read after; returns {kernel: launches}."""
    from sparsebench_tpu_torch.ops.bslab_spmv import bslab_spmv, bslab_spmv_win

    wrappers = {"K6": bslab_spmv, "K7": bslab_spmv_win}
    mtx = tmpdir / "rgl100k.mtx"
    write_rgl_mtx(mtx, 100_000)
    for w in wrappers.values():
        w.launches = 0
    hpcg = ["-f", str(REPO / "hpcg.par")]
    for label, argv in (("--fmt bslab 100^3", ["-t", "cg", "--fmt", "bslab"]),
                        ("--fmt bslab 200^3", [*hpcg, "-t", "cg", "--fmt",
                                               "bslab"]),
                        ("--fmt sell 100^3", ["-t", "cg", "--fmt", "sell"])):
        text, ran = bslab_cli_checks(cli, argv, gpu, wrappers, {"K6": 300})
        k, diff = parse_cg(text)
        print(f"[4c bslab] {label}: k={k} difference={diff} launches {ran} "
              f"| {gpu}")
        check(k == 150 and diff < F32_DIFF_BOUND,
              f"{label}: k={k}, difference {diff}")
        if "sell" in label:
            check("bridged to the bslab device build" in text,
                  "--fmt sell did not print the bridge line")
    text, ran = bslab_cli_checks(cli, [*RGL_ARGS, "-t", "cg"], gpu, wrappers,
                                 {auto_kernel: 2})
    k, diff = parse_cg(text)
    print(f"[4c bslab] generateRGL 2M -t cg: k={k} difference={diff} "
          f"launches {ran} | {gpu}")
    check(diff < F32_DIFF_BOUND, f"generateRGL cg: difference {diff}")
    text, ran = bslab_cli_checks(cli, [*RGL_ARGS, "-t", "spmv"], gpu,
                                 wrappers, {auto_kernel: 150})
    m = re.search(r"spMVM best per-iteration time: (\S+) ms", text)
    check(m is not None, "generateRGL spmv output missing")
    print(f"[4c bslab] generateRGL 2M -t spmv: launches {ran}, reported "
          f"per-SpMV time {m.group(1)} ms | {gpu}")
    text, ran = bslab_cli_checks(
        cli, [*RGL_ARGS, "-t", "spmv", "--impl", "kernel_win"], gpu,
        wrappers, {"K7": 150})
    m = re.search(r"spMVM best per-iteration time: (\S+) ms", text)
    check(m is not None, "generateRGL spmv --impl kernel_win output missing")
    print(f"[4c bslab] generateRGL 2M -t spmv --impl kernel_win: launches "
          f"{ran}, reported per-SpMV time {m.group(1)} ms | {gpu}")
    text, ran = bslab_cli_checks(cli, ["-m", str(mtx), "-t", "cg"], gpu,
                                 wrappers, {auto_kernel: 2})
    res = [float(v) for v in re.findall(r"Residual = (\S+)", text)]
    k = int(re.search(r"Solution performed (\d+) iterations", text).group(1))
    check("(format bslab)" in text, "the .mtx run did not fall back to bslab")
    check(k > 1 and np.isfinite(res).all() and res[-1] < 1e-5 * res[0],
          f".mtx fallback: k={k}, residuals {res[:3]}...{res[-1:]}")
    print(f"[4c bslab] -m rgl100k.mtx -t cg (auto: DIA refuses, bslab): k={k}"
          f" residual {res[0]:.6e} -> {res[-1]:.6e} launches {ran} | {gpu}")
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[4c bslab] launches over the bslab path: {launches}")
    for key, count in launches.items():
        check(count > 0, f"{key} was not launched on the bslab path")
    return launches


def bslab_to_csr(A):
    """The bslab matrix as a torch.sparse_csr_tensor (f32 values, int32
    indices), built on the device, for the cuSPARSE yardstick."""
    import torch

    dev = A.device
    t = torch.arange(A.n_tiles, device=dev)[:, None, None, None]
    s = torch.arange(A.sub, device=dev)[None, None, :, None]
    lane = torch.arange(128, device=dev)[None, None, None, :]
    row = ((t * A.sub + s) * 128 + lane).expand(-1, 1, -1, -1)
    parts = []
    classes = [(A.meta_aff, A.vals_aff, None, None),
               (A.meta_gen, A.vals_gen, A.lidx_gen, None),
               (A.meta_wide, A.vals_wide, A.lidx_wide, A.dblk_wide)]
    for meta, vals, lidx, dblk in classes:
        if vals.shape[1] == 0:
            continue
        blk = meta[:, :, 0].long()[:, :, None, None] + s - A.lead
        if lidx is None:
            idx = (lane + meta[:, :, 1].long()[:, :, None, None]) & 127
        else:
            idx = lidx.long()
        if dblk is not None:
            blk = blk + dblk.long()
        col = blk * 128 + idx
        keep = vals != 0
        parts.append((row.expand_as(col)[keep], col[keep],
                      vals[keep].float()))
    r = torch.cat([p[0] for p in parts])
    c = torch.cat([p[1] for p in parts])
    v = torch.cat([p[2] for p in parts])
    order = torch.argsort(r * A.nc + c)
    r, c, v = r[order], c[order], v[order]
    crow = torch.zeros(A.nr + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=A.nr), 0)
    return torch.sparse_csr_tensor(crow.to(torch.int32), c.to(torch.int32),
                                   v, (A.nr, A.nc), check_invariants=False)


def phase5c_times(dev, gpu):
    """Per-call ms of K6, K7 and the plain version (graph replay, eager
    beside it), bounds, physical GB/s and cuSPARSE at 100^3, 200^3 and RGL
    2M, and CG x150 seconds on each; returns {kernel: {case: {...}}}."""
    import torch

    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.base import physical_spmv_bytes
    from sparsebench_tpu_torch.formats.bslab import BslabMatrix
    from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab
    from sparsebench_tpu_torch.ops.bslab_spmv import (
        bslab_spmv,
        bslab_spmv_torch,
        bslab_spmv_win,
        win_fits,
    )
    from sparsebench_tpu_torch.solvers.cg import init_vectors, solve_cg

    f32 = DTypePolicy.from_names("f32")
    out = {"K6": {}, "K7": {}}
    rng = np.random.default_rng(5)
    for case in ("100", "200", "rgl"):
        if case == "rgl":
            A, _ = rgl_bslab(RGL_N, 512, 16.0, 1, device=dev, policy=f32)
            b = rng.standard_normal(A.nr).astype(np.float32)
            xexact = None
        else:
            n = int(case)
            A, counts = BslabMatrix.from_stencil(n, n, n, device=dev,
                                                 policy=f32)
            _x0, b, xexact = init_vectors(dtype=np.float32,
                                          row_lengths=counts)
        sl = A.slices
        x = torch.from_numpy(rng.standard_normal(A.nc).astype(
            np.float32)).to(dev)
        phys = physical_spmv_bytes(A, 4)
        b_ms, b_by = bound(phys, 2 * A.nnz)
        plain = lambda: bslab_spmv_torch(sl, x, sub=A.sub,  # noqa: E731
                                         lead=A.lead, x_rows=A.x_rows)
        if case == "rgl":
            csr = bslab_to_csr(A)
        else:
            from sparsebench_tpu_torch.formats.dia import DiaMatrix

            csr = dia_to_csr(DiaMatrix.from_stencil(n, n, n, device=dev,
                                                    policy=f32)[0])
        lib_err = float((csr @ x - bslab_spmv(sl, x, sub=A.sub,
                                              lead=A.lead).reshape(-1)[
                                                  :A.nr]).abs().max())
        lib_ms = min(time_graph(lambda: csr @ x) for _ in range(2))
        del csr
        kernels = {"K6": lambda: bslab_spmv(sl, x, sub=A.sub, lead=A.lead)}
        if win_fits(sl, A.w_blocks, x.dtype):
            kernels["K7"] = lambda: bslab_spmv_win(
                A.wchunk, sl, x, sub=A.sub, lead=A.lead, w_blocks=A.w_blocks)
        label = "RGL 2M" if case == "rgl" else f"{case}^3"
        for key, fn in kernels.items():
            k_ms, p_ms, ms, eager = time_pair(fn, plain)
            out[key][case] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms,
                                  eager_ms=eager)
            print(f"[5c times] {key} {label} f32 (values "
                  f"{str(A.vals_gen.dtype if A.s_gen else A.vals_aff.dtype)}"
                  f", slices {A.s_aff}/{A.s_gen}/{A.s_wide}): kernel "
                  f"{ms['kernel']} ms, plain {ms['plain']} ms (graph replay);"
                  f" kernel eager {eager:.6f} ms; physical {phys} B -> "
                  f"kernel {phys / (k_ms * 1e-3) / 1e9:.1f} GB/s; bound "
                  f"{b_ms:.6f} ms ({b_by}); cuSPARSE CSR f32 {lib_ms:.6f} ms "
                  f"(max|csr - K6| {lib_err:.3e}) | {gpu}")
        res = solve_cg(A, b, itermax=150, verbose=False)
        diff = (float(np.max(np.abs(res.x - xexact)))
                if xexact is not None else float("nan"))
        print(f"[5c times] {label} f32 bslab CG x150 (spmv {A.impl}"
              f"{', random b' if case == 'rgl' else ''}): "
              f"{res.solve_seconds:.6f} s (k={res.iterations}, max|x-1| "
              f"{diff:.3e}) | {gpu}")
        if xexact is not None:
            check(res.iterations == 150 and diff < F32_DIFF_BOUND,
                  f"{label}: CG k={res.iterations}, max|x-1| {diff}")
        del A, sl, x
        torch.cuda.empty_cache()
    # the layout of least storage (objective "bytes") against the default
    # cost model's choice, K6 on both (PERF.md, open questions)
    A, _ = rgl_bslab(RGL_N, 512, 16.0, 1, device=dev, policy=f32,
                     objective="bytes")
    x = torch.from_numpy(rng.standard_normal(A.nc).astype(np.float32)).to(dev)
    sl = A.slices
    ms = min(time_graph(lambda: bslab_spmv(sl, x, sub=A.sub, lead=A.lead))
             for _ in range(2))
    phys = physical_spmv_bytes(A, 4)
    print(f"[5c times] K6 RGL 2M f32, objective=bytes layout (slices "
          f"{A.s_aff}/{A.s_gen}/{A.s_wide}, wide_k {A.wide_k}, padding "
          f"{A.padding_ratio:.2f}): kernel {ms:.6f} ms; physical {phys} B -> "
          f"{phys / (ms * 1e-3) / 1e9:.1f} GB/s; bound "
          f"{bound(phys, 2 * A.nnz)[0]:.6f} ms | {gpu}")
    return out


# -- K8 and the solver family ---------------------------------------------------

K_SET = (1, 2, 8, 9, 16)
K_TIMED = 8


def spmm_matrices(dev):
    """(name, DiaMatrix) of phase 3d: the generated stencil at 10x9x7,
    100^3 and 200^3 (bf16 diagonals) and klein (f64, uncompressed)."""
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.dia import DiaMatrix
    from sparsebench_tpu_torch.host import read_mm

    f32 = DTypePolicy.from_names("f32")
    for dims in [(10, 9, 7), (100, 100, 100), (200, 200, 200)]:
        yield (f"stencil {dims[0]}x{dims[1]}x{dims[2]}",
               DiaMatrix.from_stencil(*dims, device=dev, policy=f32,
                                      impl="kernel")[0])
    klein = read_mm(str(REPO / "tests" / "data" / "matrix_band_klein.mtx"))
    yield "matrix_band_klein.mtx", DiaMatrix.from_csr(
        klein, DTypePolicy.from_names("f64"), device=dev, impl="kernel",
        compress=False)


def phase3d_spmm(dev):
    """K8 against dia_spmm_torch and, row by row, against K1, bit for bit;
    returns the largest |K8 - plain|."""
    import torch

    from sparsebench_tpu_torch.ops.dia_spmm import dia_spmm, dia_spmm_torch
    from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv

    dts = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
    gen = torch.Generator(device=dev).manual_seed(88)
    max_err = 0.0
    for name, A in spmm_matrices(dev):
        for td, tx in BSLAB_PAIRS:
            data = A.data.to(dts[td])
            for k in K_SET:
                X = torch.randn((k, A.nr), generator=gen, device=dev,
                                dtype=torch.float64).to(dts[tx])
                before = dia_spmm.launches
                Y = dia_spmm(data, X, A.offsets, A.nr)
                check(dia_spmm.launches == before + 1,
                      "the K8 counter did not count the launch")
                Yp = dia_spmm_torch(data, X, A.offsets, A.nr)
                same = bits_equal(Y, Yp)
                same_k1 = all(bits_equal(Y[c], dia_spmv(data, X[c],
                                                        A.offsets, A.nr))
                              for c in range(k))
                torch.cuda.synchronize()
                ok = same and same_k1 and bool(torch.isfinite(Y).all())
                max_err = max(max_err,
                              float((Y.double() - Yp.double()).abs().max()))
                print(f"[3d K8] {name} data {td} X {tx} k={k}: bit-identical "
                      f"to the plain version {same}, to K1 row by row "
                      f"{same_k1} {'ok' if ok else 'FAIL'}")
                check(ok, f"K8 disagrees on {name} {td}/{tx} k={k}")
                del X, Y, Yp
        del A, data
        torch.cuda.empty_cache()
    return max_err


def parse_residuals(text: str):
    return [float(v) for v in re.findall(r"Residual = (\S+)", text)]


def phase4d_solvers(cli, gpu, tmpdir: Path):
    """The solver family through the CLI; returns K8's launches over the
    --nrhs 8 runs (the count set to 0 before them and read after)."""
    import torch

    from sparsebench_tpu_torch.ops.dia_spmm import dia_spmm
    from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv

    hpcg = ["-f", str(REPO / "hpcg.par")]
    dia_spmm.launches = 0
    for size, argv in (("100^3", ["-t", "cg", "--nrhs", str(K_TIMED)]),
                       ("200^3", [*hpcg, "-t", "cg", "--nrhs",
                                  str(K_TIMED)])):
        before = dia_spmm.launches
        text = run_cli(cli.main, argv)
        n = dia_spmm.launches - before
        k, diff = parse_cg(text)
        print(f"[4d solvers] {size} -t cg --nrhs {K_TIMED}: k={k} difference="
              f"{diff} K8 launches={n} | {gpu}")
        check(f"Blocked CG: {K_TIMED} right-hand sides" in text,
              "the blocked CG line is missing")
        check(k == 150 and diff < F32_DIFF_BOUND,
              f"--nrhs {K_TIMED} at {size}: k={k}, difference {diff}")
        # warm-up and timed solve: each 1 + 149 products of the block
        check(n >= 2 * 150, f"--nrhs at {size}: only {n} K8 launches")
    launches = dia_spmm.launches
    print(f"[4d solvers] K8 launches over the --nrhs runs: {launches}")
    ck = tmpdir / "cg_checkpoint.npz"
    ck.unlink(missing_ok=True)
    runs = [
        (["-t", "gmres"], "residual"), (["-t", "cheb"], "residual"),
        (["-t", "bicgstab"], "diff"), (["-t", "minres"], "diff"),
        (["-t", "cg", "--precond", "jacobi"], "diff"),
        (["-t", "cg", "--precond", "cheb"], "diff"),
        (["-t", "cg", "--precond", "cheb-jacobi"], "diff"),
        (["-t", "cg", "--cg-variant", "sstep"], "diff"),
        (["-t", "cg", "--cg-variant", "pipe"], "diff"),
        (["-t", "cg", "--refine"], "diff"),
        (["-t", "cg", "--checkpoint", str(ck)], "diff"),
    ]
    # the initial residuals of GMRES (b = 1) and of the others (x0 = 0)
    from sparsebench_tpu_torch.formats.stencil import stencil_row_counts

    r0 = {"gmres": 1000.0, "cheb": float(np.linalg.norm(
        27.0 - (stencil_row_counts(100, 100, 100) - 1.0)))}
    for argv, judge in runs:
        before = dia_spmv.launches
        text = run_cli(cli.main, argv)
        n = dia_spmv.launches - before
        res = parse_residuals(text) or [float(v) for v in re.findall(
            r"checkpoint @ iteration \d+ residual (\S+) ->", text)]
        if argv[:2] == ["-t", "cheb"]:
            res = [float(re.search(r"final residual (\S+)\)", text).group(1))]
        d = re.search(r"Difference between computed and exact\s+=\s+(\S+)",
                      text)
        diff = float(d.group(1)) if d else float("nan")
        print(f"[4d solvers] 100^3 {' '.join(argv)}: last residual "
              f"{res[-1]:.6e}, difference {diff} K1 launches={n} | {gpu}")
        check(n > 0 and np.isfinite(res).all(),
              f"{argv}: {n} K1 launches, residuals {res[-3:]}")
        if judge == "diff":
            check(diff < F32_DIFF_BOUND, f"{argv}: difference {diff}")
        else:  # GMRES and Chebyshev print no exact-solution check
            check(res[-1] < 1e-6 * r0[argv[1]],
                  f"{argv}: last residual {res[-1]}, initial {r0[argv[1]]}")
    check(ck.exists(), "--checkpoint wrote no file")
    # f64 histories through the kernels against the plain versions
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.dia import DiaMatrix
    from sparsebench_tpu_torch.solvers.cg import init_vectors
    from sparsebench_tpu_torch.solvers.cg_multi import solve_cg_multi
    from sparsebench_tpu_torch.solvers.gmres import solve_gmres

    f64 = DTypePolicy.from_names("f64")
    out = {}
    for impl in ("kernel", "torch"):
        A, counts = DiaMatrix.from_stencil(40, 40, 40, device=torch.device(
            "cuda"), policy=f64, impl=impl)
        _x, b, _xe = init_vectors(row_lengths=counts)
        B = np.random.default_rng(12).standard_normal((A.nr, 4))
        B[:, 0] = b
        out[impl] = (solve_cg_multi(A, B, itermax=150, verbose=False),
                     solve_gmres(A, np.ones(A.nr), itermax=150, restart=10,
                                 verbose=False))
    for i, what in enumerate(("--nrhs 4", "-t gmres")):
        rk, rt = out["kernel"][i], out["torch"][i]
        hk, ht = rk.residual_history, rt.residual_history
        h0 = ht[0] if i == 0 else np.sqrt(40.0 ** 3)
        sel = ~np.isnan(ht) & (ht >= NOISE_FLOOR * h0)
        rel = float(np.max(np.abs(hk[sel] - ht[sel]) / ht[sel]))
        same = bool(np.array_equal(hk, ht, equal_nan=True))
        print(f"[4d solvers] f64 40^3 {what} history kernel vs plain: "
              f"k={rk.iterations}/{rt.iterations}, {int(sel.sum())} entries "
              f"above the noise floor, max rel diff {rel:.3e} (rtol "
              f"{HIST_RTOL}); bit-identical {same}")
        check(rk.iterations == rt.iterations and rel <= HIST_RTOL,
              f"f64 {what} history differs")
    # GMRES's and s-step CG's products must run in full f32
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 matrix products would run in TF32")
    print("[4d solvers] f32 matmul: allow_tf32 False, precision highest")
    return launches


def phase5d_times(dev, gpu):
    """K8 at k = 8 beside its bound, eight K1 calls, the plain version and
    cuSPARSE SpMM; blocked and single-RHS CG seconds; each new solver's
    seconds at 100^3. Returns {n: {...}} of K8's numbers."""
    import torch

    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.dia import DiaMatrix
    from sparsebench_tpu_torch.ops.dia_spmm import dia_spmm, dia_spmm_torch
    from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv
    from sparsebench_tpu_torch.solvers.cg import init_vectors, solve_cg
    from sparsebench_tpu_torch.solvers.cg_multi import solve_cg_multi

    f32 = DTypePolicy.from_names("f32")
    gen = torch.Generator(device=dev).manual_seed(21)
    k = K_TIMED
    out = {}
    for n in (100, 200):
        A, counts = DiaMatrix.from_stencil(n, n, n, device=dev, policy=f32,
                                           impl="kernel")
        X = torch.randn((k, A.nr), generator=gen, device=dev)
        rows = [X[c] for c in range(k)]
        d, offs, nr = A.data, A.offsets, A.nr
        k_ms, p_ms, ms, eager = time_pair(
            lambda: dia_spmm(d, X, offs, nr),
            lambda: dia_spmm_torch(d, X, offs, nr))
        k1x8 = min(time_graph(lambda: [dia_spmv(d, x, offs, nr)
                                       for x in rows]) for _ in range(2))
        csr = dia_to_csr(A)
        X_nk = X.t().contiguous()  # the (n, k) block, outside the timing
        lib_err = float((torch.sparse.mm(csr, X_nk).t()
                         - dia_spmm(d, X, offs, nr)).abs().max())
        lib_ms = min(time_graph(lambda: torch.sparse.mm(csr, X_nk))
                     for _ in range(2))
        del csr, X_nk
        nbytes = len(offs) * nr * d.element_size() + 2 * k * nr * 4
        b_ms, b_by = bound(nbytes, 2 * A.nnz * k)
        out[n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                      library_ms=lib_ms, eager_ms=eager, k1x8_ms=k1x8)
        print(f"[5d times] K8 {n}^3 k={k} f32 (bf16 diagonals): kernel "
              f"{ms['kernel']} ms, plain {ms['plain']} ms (graph replay); "
              f"kernel eager {eager:.6f} ms; {k} x K1 {k1x8:.6f} ms; "
              f"{nbytes} B -> kernel {nbytes / (k_ms * 1e-3) / 1e9:.1f} "
              f"GB/s; bound {b_ms:.6f} ms ({b_by}); cuSPARSE SpMM CSR f32 "
              f"{lib_ms:.6f} ms (max|spmm - K8| {lib_err:.3e}) | {gpu}")
        _x0, b, xexact = init_vectors(dtype=np.float32, row_lengths=counts)
        B = np.repeat(b[:, None], k, axis=1)
        multi = solve_cg_multi(A, B, itermax=150, verbose=False)
        single = solve_cg(A, b, itermax=150, verbose=False)
        diff = float(np.max(np.abs(multi.x - xexact[:, None])))
        print(f"[5d times] {n}^3 f32 CG x150 --nrhs {k}: "
              f"{multi.solve_seconds:.6f} s, "
              f"{multi.solve_seconds / k:.6f} s per right-hand side; one "
              f"single-RHS solve {single.solve_seconds:.6f} s (max|x-1| "
              f"{diff:.3e}) | {gpu}")
        check(multi.iterations == 150 and diff < F32_DIFF_BOUND,
              f"{n}^3 blocked CG: k={multi.iterations}, max|x-1| {diff}")
        out[n]["cg_nrhs8_s"] = multi.solve_seconds
        out[n]["cg_single_s"] = single.solve_seconds
        del A, X, rows, d, multi
        torch.cuda.empty_cache()
    solver_seconds(dev, gpu)
    return out


def solver_seconds(dev, gpu) -> None:
    """Timed-solve seconds of each new solver at 100^3, f32, through K1
    (each solver's own warm-up first), beside standard CG's."""
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.dia import DiaMatrix
    from sparsebench_tpu_torch.solvers.bicgstab import solve_bicgstab
    from sparsebench_tpu_torch.solvers.cg import init_vectors, solve_cg
    from sparsebench_tpu_torch.solvers.chebyshev import solve_chebyshev
    from sparsebench_tpu_torch.solvers.gmres import solve_gmres
    from sparsebench_tpu_torch.solvers.minres import solve_minres
    from sparsebench_tpu_torch.solvers.precond import cheb_precond_for
    from sparsebench_tpu_torch.solvers.refine import solve_cg_refine

    import torch

    f32 = DTypePolicy.from_names("f32")
    A, counts = DiaMatrix.from_stencil(100, 100, 100, device=dev, policy=f32,
                                       impl="kernel")
    A_lo, _ = DiaMatrix.from_stencil(100, 100, 100, device=dev,
                                     policy=DTypePolicy.from_names("bf16"),
                                     impl="kernel")
    _x0, b, xexact = init_vectors(dtype=np.float32, row_lengths=counts)
    inv = np.full(A.nr, 1.0 / 27.0)
    cheb = cheb_precond_for(A, A.nr, torch.float32)
    cheb_j = cheb_precond_for(A, A.nr, torch.float32, inv_diag=inv)
    runs = {
        "cg standard": lambda: solve_cg(A, b, verbose=False),
        "cg --precond jacobi": lambda: solve_cg(A, b, inv_diag=inv,
                                                verbose=False),
        "cg --precond cheb": lambda: solve_cg(A, b, precond=cheb,
                                              verbose=False),
        "cg --precond cheb-jacobi": lambda: solve_cg(
            A, b, inv_diag=inv, precond=cheb_j, verbose=False),
        "cg --cg-variant cs": lambda: solve_cg(A, b, variant="cs",
                                               verbose=False),
        "cg --cg-variant sstep": lambda: solve_cg(A, b, variant="sstep",
                                                  verbose=False),
        "cg --cg-variant pipe": lambda: solve_cg(A, b, variant="pipe",
                                                 verbose=False),
        "cg --refine": lambda: solve_cg_refine(A, b, A_lo=A_lo,
                                               inner_iters=150,
                                               verbose=False),
        "gmres": lambda: solve_gmres(A, np.ones(A.nr, np.float32),
                                     verbose=False),
        "cheb": lambda: solve_chebyshev(A, b, verbose=False),
        "bicgstab": lambda: solve_bicgstab(A, b, verbose=False),
        "minres": lambda: solve_minres(A, b, verbose=False),
    }
    for name, fn in runs.items():
        res = fn()
        diff = (float(np.max(np.abs(res.x - xexact))) if name != "gmres"
                else float("nan"))
        print(f"[5d times] 100^3 f32 {name} x150: {res.solve_seconds:.6f} s "
              f"(iterations {res.iterations}, final residual "
              f"{res.final_normr:.6e}, max|x-1| {diff:.3e}) | {gpu}")
        check(np.isfinite(res.final_normr), f"{name}: non-finite residual")


def memroof_cases():
    """(n_tiles, reps, tile_rows) of phase 3e: small and odd shapes (the
    unrolled loop's remainder at 63 steps), and the measurement's own array
    (64 Mi floats in 2048-row tiles) at its two rep counts."""
    from sparsebench_tpu_torch.ops.memroof import LANES, TILE_ROWS

    n_main = MEMROOF_FLOATS // (TILE_ROWS * LANES)
    return ((1, 1, 8), (3, 2, 16), (7, 9, TILE_ROWS), (n_main, 4, TILE_ROWS),
            (n_main, 12, TILE_ROWS))


def phase3e_memroof(dev):
    """K12 against read_passes_torch, bit for bit; ``out`` exact on ones
    and, on random data, within the bound of its f32 sum of the strips in
    step order; the sink's total within the bound of its per-thread serial
    sums and the block trees. Returns the largest |kernel - plain|."""
    import torch

    from sparsebench_tpu_torch.ops.memroof import (
        LANES,
        STRIP_ROWS,
        read_passes,
        read_passes_torch,
    )

    eps = float(torch.finfo(torch.float32).eps)
    gen = torch.Generator(device=dev).manual_seed(31)
    max_err = 0.0
    for n_tiles, reps, tile_rows in memroof_cases():
        shape = (n_tiles * tile_rows, LANES)
        for fill in ("ones", "randn"):
            x = (torch.ones(shape, device=dev) if fill == "ones"
                 else torch.randn(shape, generator=gen, device=dev))
            before = read_passes.launches
            out, sink = read_passes(x, n_tiles, reps, tile_rows)
            check(read_passes.launches == before + 1,
                  "the K12 counter did not count the launch")
            out_p, sink_p = read_passes_torch(x, n_tiles, reps, tile_rows)
            torch.cuda.synchronize()
            same = bits_equal(out, out_p) and bits_equal(sink, sink_p)
            max_err = max(max_err, float((out - out_p).abs().max()),
                          float((sink - sink_p).abs().max()))
            n_steps = reps * n_tiles
            strips = x.view(n_tiles, tile_rows, LANES)[:, :STRIP_ROWS]
            exact = reps * strips.double().sum(0)
            tol = n_steps * eps * reps * strips.double().abs().sum(0)
            out_err = float((out.double() - exact).abs().max())
            out_ok = bool(((out.double() - exact).abs() <= tol).all())
            # a value read passes through at most 4 n_steps serial adds in
            # its thread and the 8 levels of the block's tree
            n_terms = reps * x.numel()
            total = float(sink.double().sum())
            exact_total = reps * float(x.double().sum())
            tol_total = ((4 * n_steps + 8) * eps * reps
                         * float(x.double().abs().sum()))
            sink_ok = abs(total - exact_total) <= tol_total
            if fill == "ones":
                out_ok = out_ok and bool((out == n_steps).all())
                sink_ok = sink_ok and total == n_terms
            ok = same and out_ok and sink_ok and bool(
                torch.isfinite(out).all())
            print(f"[3e K12] {fill} n_tiles={n_tiles} reps={reps} tile_rows="
                  f"{tile_rows}: bit-identical to the plain version {same}; "
                  f"out max|out - exact| {out_err:.3e} within its bound "
                  f"{out_ok}; sink total {total:.9e} vs exact "
                  f"{exact_total:.9e} within {tol_total:.3e} {sink_ok} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"K12 disagrees: {fill} {n_tiles} {reps} {tile_rows}")
            del x, out, sink, out_p, sink_p, strips, exact, tol
    torch.cuda.empty_cache()
    return max_err


def phase4e_profile(cli, gpu):
    """``-t cg --profile`` at 100^3 and 200^3 through the CLI (k = 150, the
    difference below F32_DIFF_BOUND, the region table with a nonzero spMVM
    rate), the K1 count set to 0 before and read after; then ``--banner``.
    Returns K1's launches over the two profiled runs."""
    import torch

    from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv

    dia_spmv.launches = 0
    for size, argv in (("100^3", ["-t", "cg", "--profile"]),
                       ("200^3", ["-f", str(REPO / "hpcg.par"), "-t", "cg",
                                  "--profile"])):
        before = dia_spmv.launches
        text = run_cli(cli.main, argv)
        n = dia_spmv.launches - before
        k, diff = parse_cg(text)
        rows = dict(re.findall(r"^(\w+):\s+(\S+)\s+\S+\s+\S+$", text, re.M))
        print(f"[4e profile] {size} -t cg --profile: k={k} difference={diff} "
              f"K1 launches={n} spMVM rate {rows.get('spMVM')} MB/s | {gpu}")
        check(k == 150 and diff < F32_DIFF_BOUND,
              f"--profile at {size}: k={k}, difference {diff}")
        check(list(rows) == ["waxpby", "spMVM", "ddot"]
              and float(rows["spMVM"]) > 0, f"--profile table: {rows}")
        # the untimed warm-up product, the initial one, 149 in the loop
        check(n >= 150, f"--profile at {size}: only {n} K1 launches")
    launches = dia_spmv.launches
    text = run_cli(cli.main, ["-t", "cg", "--banner", "-x", "16", "-y", "16",
                              "-z", "16", "-i", "10"])
    check(re.search(r"^Process \d+ on host \S+:$", text, re.M) is not None
          and torch.cuda.get_device_name(0) in text
          and "power limit" in text, "--banner printed no device table")
    print(f"[4e profile] --banner printed the device table; K1 launches over "
          f"the --profile runs: {launches}")
    return launches


def phase5e_memroof_times(dev, gpu):
    """K12: the bench's read ceiling (``measure_dma_read_gbps`` with its
    defaults) with the K12 count set to 0 before and read after; one
    reps = 4 launch per pass beside the plain version, torch.sum over the
    same array and the bound of a pass. Returns (K12's launches in the
    measurement, K12's row numbers)."""
    import torch

    from sparsebench_tpu_torch.ops.memroof import (
        LANES,
        TILE_ROWS,
        measure_dma_read_gbps,
        read_passes,
        read_passes_torch,
    )

    read_passes.launches = 0
    gbps = measure_dma_read_gbps()
    launches = read_passes.launches
    check(launches == 8, f"measure_dma_read_gbps launched K12 {launches} "
          "times, expected 8")
    nbytes = MEMROOF_FLOATS * 4
    n_tiles = MEMROOF_FLOATS // (TILE_ROWS * LANES)
    x = torch.ones((n_tiles * TILE_ROWS, LANES), device=dev)
    reps = 4
    k_ms, p_ms, ms, _eager = time_pair(
        lambda: read_passes(x, n_tiles, reps),
        lambda: read_passes_torch(x, n_tiles, reps), graph=False, reps=5)
    lib_ms = min(time_graph(lambda: torch.sum(x)) for _ in range(2))
    b_ms, b_by = bound(nbytes, MEMROOF_FLOATS)
    diff_ms = nbytes / (gbps * 1e9) * 1e3
    print(f"[5e K12] {MEMROOF_FLOATS} f32 ({nbytes / 2**20:.0f} MiB), "
          f"2048-row tiles: read ceiling {gbps:.1f} GB/s "
          f"({gbps / (HBM_BYTES_PER_S / 1e9):.3f} of 3350), differential "
          f"{diff_ms:.6f} ms a pass, K12 launches={launches}; one reps={reps} "
          f"launch {ms['kernel']} ms -> {k_ms / reps:.6f} ms a pass; plain "
          f"{ms['plain']} ms -> {p_ms / reps:.6f} ms a pass; torch.sum "
          f"{lib_ms:.6f} ms ({nbytes / (lib_ms * 1e-3) / 1e9:.1f} GB/s); "
          f"bound {b_ms:.6f} ms a pass ({b_by}) | {gpu}")
    check(0 < gbps <= 1.02 * HBM_BYTES_PER_S / 1e9,
          f"read ceiling {gbps} GB/s is not below the data sheet's rate")
    del x
    torch.cuda.empty_cache()
    return launches, dict(ms=k_ms / reps, plain_ms=p_ms / reps,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          dma_read_GBps=gbps, ms_differential=diff_ms)


# -- K9, K10 and K11: the bsell SpMV ------------------------------------------


def banded_csr(n: int, band: int, density: float, seed: int):
    """A numpy-seeded random banded host CSR (rows column-sorted, a unit
    diagonal shift keeps it nonsingular)."""
    from sparsebench_tpu_torch.host import HostCSR

    rng = np.random.default_rng(seed)
    per_row = max(1, int(density * (2 * band + 1)))
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-band, band + 1, rows.size), 0, n - 1)
    keys = np.unique(np.concatenate([rows * n + cols,
                                     np.arange(n) * (n + 1)]))
    r, c = keys // n, keys % n
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=row_ptr[1:])
    val = rng.standard_normal(r.size) + np.where(r == c, 2.0 * band, 0.0)
    return HostCSR(row_ptr=row_ptr, col=c.astype(np.int64), val=val, nr=n,
                   nc=n)


def bsell_matrices(dev):
    """(name, BsellMatrix) of phase 3f, built one at a time with the f32
    policy (bf16 values where lossless): the stencil through the host CSR
    (the CLI's build) at 7x6x5, 20^3 and 100^3 and on the device
    (``from_stencil``) at 10x9x7, 20x20x12, 100^3 and 200^3, klein and the
    small test matrices, and a random banded matrix of 50k rows."""
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.bsell import BsellMatrix
    from sparsebench_tpu_torch.host import generate_stencil, read_mm

    f32 = DTypePolicy.from_names("f32")
    for dims in [(7, 6, 5), (20, 20, 20), (100, 100, 100)]:
        yield (f"stencil {dims[0]}x{dims[1]}x{dims[2]} from_csr",
               BsellMatrix.from_csr(generate_stencil(*dims), f32, device=dev))
    for dims in [(10, 9, 7), (20, 20, 12), (100, 100, 100), (200, 200, 200)]:
        yield (f"stencil {dims[0]}x{dims[1]}x{dims[2]} from_stencil",
               BsellMatrix.from_stencil(*dims, device=dev, policy=f32)[0])
    data = REPO / "tests" / "data"
    files = [data / "matrix_band_klein.mtx"] + sorted(
        (data / "testMatrices").glob("test*.mtx"))
    for path in files:
        yield path.name, BsellMatrix.from_csr(read_mm(str(path)), f32,
                                              device=dev)
    yield "banded random 50k", BsellMatrix.from_csr(
        banded_csr(50_000, 300, 0.05, 3), f32, device=dev)


def phase3f_bsell(dev):
    """K9, K10 and K11 against bsell_spmv_torch, bit for bit, in all three
    (values, x) pairs; K10 and K11 wherever the window fits, and a refusal
    checked where it does not. Returns {kernel: max |kernel - plain|}."""
    import torch

    from sparsebench_tpu_torch.ops.bsell_spmv import (
        LANES,
        bsell_spmv,
        bsell_spmv_torch,
        bsell_spmv_win2,
        bsell_spmv_windowed,
        win_fits,
        win_smem_bytes,
    )

    dts = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}
    rng = np.random.default_rng(41)
    err = {"K9": 0.0, "K10": 0.0, "K11": 0.0}
    win_cases = refused = 0
    windowed = (("K10", bsell_spmv_win2), ("K11", bsell_spmv_windowed))
    for name, A in bsell_matrices(dev):
        x0 = rng.standard_normal(A.nc)
        for td, tx in BSLAB_PAIRS:
            vals = A.vals.to(dts[td])
            x = torch.from_numpy(x0).to(dev, dts[tx])
            x2d = A.padded_x(x, A.nc_pad // LANES)
            y_p = bsell_spmv_torch(A.blocks, A.win_base, x2d, vals, A.lidx)
            before = bsell_spmv.launches
            y_k = bsell_spmv(A.blocks, A.win_base, x2d, vals, A.lidx)
            check(bsell_spmv.launches == before + 1,
                  "the K9 counter did not count the launch")
            torch.cuda.synchronize()
            same = bits_equal(y_k, y_p) and bool(torch.isfinite(y_k).all())
            err["K9"] = max(err["K9"], float((y_k - y_p).abs().max()))
            line, ok = f"K9 bit-identical {same}", same
            xw = A.padded_x(x, A.xw_rows)
            if win_fits(A.w_blocks, x.dtype):
                for key, fn in windowed:
                    before = fn.launches
                    y_w = fn(A.wchunk, A.blocks, xw, vals, A.lidx,
                             w_blocks=A.w_blocks)
                    check(fn.launches == before + 1,
                          f"the {key} counter did not count the launch")
                    torch.cuda.synchronize()
                    same_w = bits_equal(y_w, y_p)
                    err[key] = max(err[key], float((y_w - y_p).abs().max()))
                    line += f"; {key} bit-identical {same_w}"
                    ok &= same_w
                win_cases += 1
            else:
                need = win_smem_bytes(A.w_blocks, x.dtype)
                for key, fn in windowed:
                    try:
                        fn(A.wchunk, A.blocks, xw, vals, A.lidx,
                           w_blocks=A.w_blocks)
                        check(False, f"{key} ran a {need} B window")
                    except ValueError as e:
                        check(str(need) in str(e), f"{key} refused with "
                              f"another message: {e}")
                refused += 1
                line += f"; K10/K11 window {need} B does not fit: refused"
            print(f"[3f bsell] {name} ({A.n_tiles} tiles, s_max {A.s_max}, W "
                  f"{A.w_blocks}, auto {A.impl}) values {td} x {tx}: {line} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"K9-K11 disagree with the plain version on {name} "
                  f"{td}/{tx}")
            del vals, x, x2d, xw, y_p, y_k
        del A
        torch.cuda.empty_cache()
    check(win_cases > 0 and refused > 0,
          f"K10/K11 compared on {win_cases} cases, refused on {refused}")
    return err


BSELL_KERNELS = ("K9", "K10", "K11")


def bsell_wrappers():
    from sparsebench_tpu_torch.ops.bsell_spmv import (
        bsell_spmv,
        bsell_spmv_win2,
        bsell_spmv_windowed,
    )

    return dict(zip(BSELL_KERNELS, (bsell_spmv, bsell_spmv_win2,
                                    bsell_spmv_windowed)))


def phase4f_bsell(cli, gpu):
    """The bsell path through the CLI at 100^3 (the host CSR build, as the
    JAX CLI builds it) with the K9-K11 counts set to 0 before and read
    after; returns {kernel: launches}."""
    wrappers = bsell_wrappers()
    for w in wrappers.values():
        w.launches = 0
    # warm-up and timed solve, 150 SpMVs each; auto adds the build's check
    for impl, key in (("auto", "K9"), ("kernel_win2", "K10"),
                      ("kernel_win", "K11"), ("torch", None)):
        argv = ["-t", "cg", "--fmt", "bsell", "--impl", impl]
        before = {k: w.launches for k, w in wrappers.items()}
        text = run_cli(cli.main, argv)
        ran = {k: w.launches - before[k] for k, w in wrappers.items()}
        k, diff = parse_cg(text)
        print(f"[4f bsell] 100^3 -t cg --impl {impl}: k={k} difference={diff}"
              f" launches {ran} | {gpu}")
        check(k == 150 and diff < F32_DIFF_BOUND,
              f"{argv}: k={k}, difference {diff}")
        check("(format bsell)" in text, f"{argv} did not build bsell")
        for kk, n in ran.items():
            check(n >= 300 if kk == key else n == 0,
                  f"{argv}: {kk} launched {n} times")
    before = wrappers["K9"].launches
    text = run_cli(cli.main, ["-t", "spmv", "--fmt", "bsell"])
    n = wrappers["K9"].launches - before
    m = re.search(r"spMVM best per-iteration time: (\S+) ms", text)
    check(m is not None and n >= 150, f"-t spmv --fmt bsell: {n} launches")
    print(f"[4f bsell] 100^3 -t spmv --fmt bsell: K9 launches={n}, reported "
          f"per-SpMV time {m.group(1)} ms | {gpu}")
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[4f bsell] launches over the bsell path: {launches}")
    for key, count in launches.items():
        check(count > 0, f"{key} was not launched on the bsell path")
    # f64 through K9 and through the plain version: the same lines
    lines = {}
    for impl in ("kernel", "torch"):
        text = run_cli(cli.main, ["-t", "cg", "--fmt", "bsell", "--dtype",
                                  "f64", "--impl", impl])
        k, diff = parse_cg(text)
        check(k == 150 and diff < F64_DIFF_BOUND,
              f"f64 --impl {impl}: k={k}, difference {diff}")
        lines[impl] = re.findall(r"Residual = \S+", text)
    same = lines["kernel"] == lines["torch"] and len(lines["kernel"]) > 10
    print(f"[4f bsell] 100^3 f64 -t cg --fmt bsell: the {len(lines['kernel'])}"
          f" residual lines of --impl kernel and --impl torch equal: {same}")
    check(same, "f64 bsell residual lines differ between K9 and the plain "
          "version")
    return launches


def phase5f_times(dev, gpu):
    """Per-call ms of K9-K11 and the plain version (graph replay, eager
    beside it), bounds, cuSPARSE CSR f32 on the same matrix and K6 and K1 on
    the same problem, at 100^3 (host CSR and device builds) and 200^3
    (device build), and bsell CG x150 seconds; returns {kernel: {case:
    {...}}} with the cases "100" (the CLI's build), "100s" and "200"."""
    import torch

    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.bslab import BslabMatrix
    from sparsebench_tpu_torch.formats.bsell import BsellMatrix
    from sparsebench_tpu_torch.formats.dia import DiaMatrix
    from sparsebench_tpu_torch.host import generate_stencil
    from sparsebench_tpu_torch.ops.bsell_spmv import (
        LANES,
        bsell_spmv,
        bsell_spmv_torch,
        bsell_spmv_win2,
        bsell_spmv_windowed,
        win_fits,
    )
    from sparsebench_tpu_torch.solvers.cg import init_vectors, solve_cg

    f32 = DTypePolicy.from_names("f32")
    out = {k: {} for k in BSELL_KERNELS}
    rng = np.random.default_rng(17)
    others = {}  # n -> (K6 ms, K1 ms, cuSPARSE ms, csr)
    for case in ("100", "100s", "200"):
        n = int(case[:3])
        if case == "100":
            csr = generate_stencil(n, n, n)
            A = BsellMatrix.from_csr(csr, f32, device=dev)
            counts = csr.row_lengths
            del csr
        else:
            A, counts = BsellMatrix.from_stencil(n, n, n, device=dev,
                                                 policy=f32)
        x = torch.from_numpy(rng.standard_normal(A.nc).astype(
            np.float32)).to(dev)
        x2d = A.padded_x(x, A.nc_pad // LANES)
        xw = A.padded_x(x, A.xw_rows)
        if n not in others:
            Ab, _ = BslabMatrix.from_stencil(n, n, n, device=dev, policy=f32)
            Ad, _ = DiaMatrix.from_stencil(n, n, n, device=dev, policy=f32)
            csr = dia_to_csr(Ad)
            others[n] = (min(time_graph(lambda: Ab.spmv(x)) for _ in range(2)),
                         min(time_graph(lambda: Ad.spmv(x)) for _ in range(2)),
                         min(time_graph(lambda: csr @ x) for _ in range(2)),
                         csr)
            del Ab, Ad
        k6_ms, k1_ms, lib_ms, csr = others[n]
        lib_err = float((csr @ x - bsell_spmv(
            A.blocks, A.win_base, x2d, A.vals, A.lidx).reshape(-1)[
                :A.nr]).abs().max())
        planes = sum(t.numel() * t.element_size()
                     for t in (A.vals, A.lidx, A.blocks))
        y_bytes = A.n_tiles * 1024 * 4
        plain = lambda: bsell_spmv_torch(A.blocks, A.win_base,  # noqa: E731
                                         x2d, A.vals, A.lidx)
        kernels = {"K9": (lambda: bsell_spmv(A.blocks, A.win_base, x2d,
                                             A.vals, A.lidx),
                          planes + 4 * A.win_base.numel() + 4 * x2d.numel())}
        if win_fits(A.w_blocks, x.dtype):
            for key, fn in (("K10", bsell_spmv_win2),
                            ("K11", bsell_spmv_windowed)):
                kernels[key] = (
                    lambda fn=fn: fn(A.wchunk, A.blocks, xw, A.vals, A.lidx,
                                     w_blocks=A.w_blocks),
                    planes + 4 * A.wchunk.numel() + 4 * xw.numel())
        label = {"100": "100^3 host CSR build", "100s": "100^3 device build",
                 "200": "200^3 device build"}[case]
        for key, (fn, inputs) in kernels.items():
            nbytes = inputs + y_bytes
            b_ms, b_by = bound(nbytes, 2 * A.nnz)
            k_ms, p_ms, ms, eager = time_pair(fn, plain)
            out[key][case] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms,
                                  eager_ms=eager, k6_ms=k6_ms, k1_ms=k1_ms)
            print(f"[5f times] {key} {label} f32 (bf16 values, {A.n_tiles} "
                  f"tiles x {A.s_max} slices, W {A.w_blocks}, padding "
                  f"{A.padding_ratio:.2f}): kernel {ms['kernel']} ms, plain "
                  f"{ms['plain']} ms (graph replay); kernel eager "
                  f"{eager:.6f} ms; {nbytes} B -> kernel "
                  f"{nbytes / (k_ms * 1e-3) / 1e9:.1f} GB/s; bound "
                  f"{b_ms:.6f} ms ({b_by}); cuSPARSE CSR f32 {lib_ms:.6f} ms "
                  f"(max|csr - K9| {lib_err:.3e}); same problem: K6 "
                  f"{k6_ms:.6f} ms, K1 {k1_ms:.6f} ms | {gpu}")
        if not win_fits(A.w_blocks, x.dtype):
            print(f"[5f times] K10/K11 {label}: the window of 2*{A.w_blocks} "
                  f"rows does not fit a block; not timed")
        _x0, b, xexact = init_vectors(dtype=np.float32, row_lengths=counts)
        res = solve_cg(A, b, itermax=150, verbose=False)
        diff = float(np.max(np.abs(res.x - xexact)))
        print(f"[5f times] {label} f32 bsell CG x150 (spmv {A.impl}): "
              f"{res.solve_seconds:.6f} s (k={res.iterations}, max|x-1| "
              f"{diff:.3e}) | {gpu}")
        check(res.iterations == 150 and diff < F32_DIFF_BOUND,
              f"{label}: bsell CG k={res.iterations}, max|x-1| {diff}")
        del A, x, x2d, xw
        torch.cuda.empty_cache()
    return out


# -- P1-P5: the prototype kernels --------------------------------------------

PROTO_MODULES = ("csr_twopass_proto", "dia_micro", "dia_shear", "slab_micro",
                 "slab_micro2")
# the 200^3 extent of the DIA window prototypes: 245 tiles of 256 rows
DIA_TILE, DIA_GRID = 256, 245
# RGL 2M as P5 lays it out (the JAX prototype's full size)
P5_N, P5_BAND, P5_R = 2_000_000, 512, 1024


def proto_wrappers():
    """{kernel: wrapper} of P1-P5, each with its launch counter."""
    from sparsebench_tpu_torch.ops.csr_twopass import pass1_products
    from sparsebench_tpu_torch.ops.dia_window import dia_shear, dia_window
    from sparsebench_tpu_torch.ops.slab_slices import (
        slab_slices,
        slab_slices_tall,
    )

    return {"P5": pass1_products, "P1": dia_window, "P2": dia_shear,
            "P3": slab_slices, "P4": slab_slices_tall}


def counted(key, fn, *args, **kw):
    """One wrapper call that must add exactly one launch to its count."""
    w = proto_wrappers()[key]
    before = w.launches
    y = fn(*args, **kw)
    check(w.launches == before + 1, f"the {key} counter did not count the "
          "launch")
    return y


def dia_inputs(dev, n_rows: int, x_len: int, seed: int):
    """(x1d f32, data3d bf16) of 27 planes from a seeded torch.Generator."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x1d = torch.randn(x_len, generator=g, device=dev)
    data3d = torch.randn((27, n_rows, 128), generator=g,
                         device=dev).to(torch.bfloat16)
    return x1d, data3d


def phase3g_protos(dev):
    """P1-P5 against their plain versions, bit for bit: P1's four schedules
    and P2's two variants with the real 200^3 shifts at the 200^3 extent and
    at small grids, P2 with tpc 2 and 3 (partial last chunks); P3's eight
    variants with bf16 and f32 values at 54 x 1024 slices; P4's four variants
    at every SUB in both dtypes; P5's pass 1 on RGL 2M and on the small and
    phantom-row builds. Returns {kernel: max |kernel - plain|}."""
    import torch

    from sparsebench_tpu_torch.benchmarks import csr_twopass_proto as p5
    from sparsebench_tpu_torch.benchmarks.dia_micro import (
        span_rows,
        stencil_shifts,
    )
    from sparsebench_tpu_torch.benchmarks.slab_micro import (
        build_inputs,
        metas_of,
    )
    from sparsebench_tpu_torch.benchmarks.slab_micro2 import (
        SUBS,
        draw_vals,
        sub_inputs,
    )
    from sparsebench_tpu_torch.ops.csr_twopass import (
        pass1_products,
        pass1_products_torch,
    )
    from sparsebench_tpu_torch.ops.dia_window import (
        SCHEDULES,
        SHEAR_VARIANTS,
        TPU_SCHEDULE,
        dia_shear,
        dia_window,
        dia_window_torch,
        shear_x_floats,
    )
    from sparsebench_tpu_torch.ops.slab_slices import (
        P3,
        P4,
        slab_slices,
        slab_slices_tall,
        slab_slices_torch,
    )

    t0 = time.perf_counter()
    err = {k: 0.0 for k in ("P1", "P2", "P3", "P4", "P5")}
    cases = {k: 0 for k in err}

    def compare(key, label, y_k, y_p):
        torch.cuda.synchronize()
        same = bits_equal(y_k, y_p) and bool(torch.isfinite(y_k).all())
        err[key] = max(err[key], float((y_k - y_p).abs().max()))
        cases[key] += 1
        check(same, f"{key} {label}: the kernel differs from its plain "
              "version")

    shifts = stencil_shifts()
    span = span_rows(shifts)
    for tile, grid in ((DIA_TILE, DIA_GRID), (8, 3), (16, 5), (24, 7)):
        n_rows = tile * grid
        x1d, data3d = dia_inputs(dev, n_rows, (n_rows + span) * 128, grid)
        for s in SCHEDULES:
            compare("P1", f"{s} {tile}x{grid}",
                    counted("P1", dia_window, x1d, data3d, shifts, s, tile),
                    dia_window_torch(x1d, data3d, shifts, s))
        for tpc in (2, 3):
            x_len = shear_x_floats(n_rows, tile, tpc, span)
            x2, _ = dia_inputs(dev, 0, x_len, 100 * grid + tpc)
            for v in SHEAR_VARIANTS:
                compare("P2", f"{v} {tile}x{grid} tpc {tpc}",
                        counted("P2", dia_shear, x2, data3d, shifts, v, tile,
                                tpc),
                        dia_window_torch(x2, data3d, shifts,
                                         TPU_SCHEDULE[v]))
        print(f"[3g protos] P1 {SCHEDULES} and P2 {SHEAR_VARIANTS} (tpc 2, 3;"
              f" {-(-grid // 2) * 2 - grid} and {-(-grid // 3) * 3 - grid} "
              f"tiles short of a whole chunk) at {tile} x {grid} rows of 128, "
              "27 shifts of 200^3 (10 q-groups): bit-identical")
        del x1d, data3d, x2
    gen = torch.Generator(device=dev).manual_seed(7)
    x2d, vals, lidx, m_slab, m_slab_a, m_sc = build_inputs(54, 1024, gen,
                                                           device=dev)
    for vd in (torch.bfloat16, torch.float32):
        v_t = vals.to(vd)
        for variant, meta in metas_of(m_slab, m_slab_a, m_sc).items():
            compare("P3", f"{variant} {vd}",
                    counted("P3", slab_slices, meta, x2d, v_t, lidx, variant),
                    slab_slices_torch(meta, x2d, v_t, lidx, *P3[variant]))
    print(f"[3g protos] P3 {tuple(P3)} with bf16 and f32 values, 1024 tiles "
          "x 54 slices: bit-identical")
    del x2d, vals, lidx
    for sub in SUBS:
        n_tiles, x2d, lidx, meta = sub_inputs(55296, sub, gen, dev)
        for vd in (torch.bfloat16, torch.float32):
            v_t = draw_vals((n_tiles, 16, sub, 128), gen, dev).to(vd)
            for variant in P4:
                compare("P4", f"SUB {sub} {variant} {vd}",
                        counted("P4", slab_slices_tall, meta, x2d, v_t, lidx,
                                variant),
                        slab_slices_torch(meta, x2d, v_t, lidx,
                                          *P4[variant]))
    print(f"[3g protos] P4 {tuple(P4)} at SUB {SUBS} with bf16 and f32 "
          "values, 55,296 unit slices: bit-identical")
    for n, band, R in ((P5_N, P5_BAND, P5_R), (8192, 128, 512),
                       (8000, 128, 512)):
        S = p5.build_streams(n, band, 16.0, 1, R, dev)
        xpad = torch.randn(n + R + 2 * band, generator=gen, device=dev)
        compare("P5", f"n {n}",
                counted("P5", pass1_products, S["val"], S["colrel"], xpad,
                        band, R),
                pass1_products_torch(S["val"], S["colrel"], xpad, band, R))
        print(f"[3g protos] P5 pass 1, RGL n {n} band {band} R {R} ({S['nb']}"
              f" blocks x {S['block_cap']} slots, {S['nb'] * R - n} phantom "
              "rows): bit-identical")
        del S
    torch.cuda.empty_cache()
    print(f"[3g protos] {cases} cases bit-identical in "
          f"{time.perf_counter() - t0:.1f} s")
    return err


def run_module(name: str, argv: list, tmpdir: Path) -> dict:
    """``python -m sparsebench_tpu_torch.benchmarks.<name> <argv>``
    in-process: its stderr echoed, rc 0, and its final JSON line."""
    mod = importlib.import_module(f"sparsebench_tpu_torch.benchmarks.{name}")
    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(argv)
    wall = time.perf_counter() - t
    (tmpdir / f"{name}.log").write_text(err.getvalue() + out.getvalue())
    for line in err.getvalue().splitlines():
        print(f"[5g {name}] {line}")
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and lines, f"{name} {argv} exited {rc}")
    print(f"[5g {name}] {' '.join(argv) or '(defaults)'}: rc 0 in {wall:.1f} "
          f"s; {lines[-1]}")
    return json.loads(lines[-1])


def diagonals_to_csr(data3d, shifts, x_len: int):
    """The product y[i] = sum_d data[d, i] x[s_d + i] as a
    torch.sparse_csr_tensor (f32 values, int32 indices; the shifts ascend,
    so each row's columns do), for the cuSPARSE yardstick."""
    import torch

    nd, n_rows, _ = data3d.shape
    n = n_rows * 128
    dev = data3d.device
    sh = torch.tensor(shifts, dtype=torch.int32, device=dev)
    cols = (torch.arange(n, dtype=torch.int32, device=dev)[:, None]
            + sh[None, :]).reshape(-1)
    vals = data3d.reshape(nd, n).t().to(torch.float32).reshape(-1)
    crow = torch.arange(0, nd * (n + 1), nd, dtype=torch.int32, device=dev)
    return torch.sparse_csr_tensor(crow, cols, vals, (n, x_len),
                                   check_invariants=False)


def phase5g_protos(dev, gpu, tmpdir: Path, k1_200: dict):
    """The slice's main path: each prototype module at its full size, the
    P1-P5 counts set to 0 before and read after; then each kernel's
    per-call ms (graph replay) at those shapes beside its plain version, its
    bound and, for P5 (the whole SpMV) and P1/P2 (the 27-diagonal product),
    cuSPARSE CSR f32. Returns ({kernel: launches}, {kernel: times})."""
    import torch

    from sparsebench_tpu_torch.benchmarks import csr_twopass_proto as p5
    from sparsebench_tpu_torch.benchmarks.dia_micro import (
        span_rows,
        stencil_shifts,
    )
    from sparsebench_tpu_torch.benchmarks.slab_micro import (
        build_inputs,
        metas_of,
    )
    from sparsebench_tpu_torch.benchmarks.slab_micro2 import (
        SUBS,
        draw_vals,
        sub_inputs,
    )
    from sparsebench_tpu_torch.ops.csr_twopass import (
        pass1_products,
        pass1_products_torch,
    )
    from sparsebench_tpu_torch.ops.dia_window import (
        SCHEDULES,
        dia_shear,
        dia_window,
        dia_window_torch,
        shear_x_floats,
    )
    from sparsebench_tpu_torch.ops.slab_slices import (
        P3,
        P4,
        slab_slices,
        slab_slices_tall,
        slab_slices_torch,
    )

    t0 = time.perf_counter()
    wrappers = proto_wrappers()
    for w in wrappers.values():
        w.launches = 0
    runs = {
        "csr_twopass_proto": [],
        "dia_micro": [str(DIA_TILE), str(DIA_GRID)],
        "dia_shear": [str(DIA_TILE), str(DIA_GRID)],
        "slab_micro": [],
        "slab_micro2": [],
    }
    lines = {name: run_module(name, argv, tmpdir)
             for name, argv in runs.items()}
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[5g protos] launches over the five modules' runs: {launches} "
          f"({time.perf_counter() - t0:.1f} s)")
    for key, count in launches.items():
        check(count > 0, f"{key} was not launched by its module")
    rgl = lines["csr_twopass_proto"]
    check(rgl["twopass_segsum_err_ones"] == 0.0
          and rgl["cusparse_csr_err"] < 1e-3,
          f"P5 validation: {rgl}")

    times = {}

    def row(key, label, kernel, plain, nbytes, flops, lib_ms=None,
            lib_label=""):
        b_ms, b_by = bound(nbytes, flops)
        k_ms, p_ms, ms, eager = time_pair(kernel, plain)
        times[key] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms, eager_ms=eager)
        print(f"[5g times] {label}: kernel {ms['kernel']} ms, plain "
              f"{ms['plain']} ms (graph replay); kernel eager {eager:.6f} ms;"
              f" {nbytes} B -> {nbytes / (k_ms * 1e-3) / 1e9:.1f} GB/s; bound"
              f" {b_ms:.6f} ms ({b_by}); {lib_label} | {gpu}")

    # P5: pass 1 on RGL 2M; cuSPARSE CSR f32 computes the whole SpMV
    S = p5.build_streams(P5_N, P5_BAND, 16.0, 1, P5_R, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    xpad = torch.randn(P5_N + P5_R + 2 * P5_BAND, generator=gen, device=dev)
    csr = p5.streams_csr(S, P5_N, P5_BAND, P5_R)
    x = xpad[P5_BAND: P5_BAND + P5_N]
    lib_ms = min(time_graph(lambda: csr @ x) for _ in range(2))
    slots = S["val"].numel()
    row("P5", f"P5 pass 1, RGL 2M ({S['nb']} blocks x {S['block_cap']} slots, "
        f"{S['nnz']} nnz)",
        lambda: pass1_products(S["val"], S["colrel"], xpad, P5_BAND, P5_R),
        lambda: pass1_products_torch(S["val"], S["colrel"], xpad, P5_BAND,
                                     P5_R),
        12 * slots + 4 * xpad.numel(), slots, lib_ms,
        f"cuSPARSE CSR f32 SpMV {lib_ms:.6f} ms")
    times["P5"].update({f"{k}_ms": rgl[f"{k}_ms"] for k in (
        "twopass_segsum", "twopass_cumsum", "pass1_only", "csrseg_onepass",
        "positional_bslab", "cusparse_csr")})
    del S, csr, xpad, x

    # P1 and P2 at the 200^3 extent; cuSPARSE CSR f32 of the 27 diagonals
    shifts = stencil_shifts()
    span = span_rows(shifts)
    n_rows = DIA_TILE * DIA_GRID
    x1d, data3d = dia_inputs(dev, n_rows, (n_rows + span) * 128, 1)
    y_bytes = n_rows * 128 * 4
    flops = 2 * 27 * n_rows * 128
    csr = diagonals_to_csr(data3d, shifts, x1d.numel())
    lib_err = float((csr @ x1d - dia_window(
        x1d, data3d, shifts, "direct", DIA_TILE).reshape(-1)).abs().max())
    lib_ms = min(time_graph(lambda: csr @ x1d) for _ in range(2))
    del csr
    lib = (f"cuSPARSE CSR f32 {lib_ms:.6f} ms (max|csr - P1| {lib_err:.3e});"
           f" K1 at 200^3 {k1_200['ms']:.6f} ms")
    nbytes = data3d.numel() * 2 + x1d.numel() * 4 + y_bytes
    for s in SCHEDULES:
        row("P1" if s == "direct" else f"P1 {s}", f"P1 {s}, {n_rows} rows",
            lambda s=s: dia_window(x1d, data3d, shifts, s, DIA_TILE),
            lambda s=s: dia_window_torch(x1d, data3d, shifts, s),
            nbytes, flops, lib_ms, lib)
    x2, _ = dia_inputs(dev, 0, shear_x_floats(n_rows, DIA_TILE, 2, span), 2)
    nbytes = data3d.numel() * 2 + x2.numel() * 4 + y_bytes
    for v in ("shear_chunk", "roll"):
        row("P2" if v == "shear_chunk" else f"P2 {v}",
            f"P2 {v}, {n_rows} rows, tpc 2",
            lambda v=v: dia_shear(x2, data3d, shifts, v, DIA_TILE, 2),
            lambda v=v: dia_window_torch(x2, data3d, shifts,
                                         "direct"),
            nbytes, flops, lib_ms, lib)
    for key in ("P1", "P2"):
        times[key]["k1_200_ms"] = k1_200["ms"]
    for s in SCHEDULES[1:]:
        times["P1"][f"ms_{s}"] = times.pop(f"P1 {s}")["ms"]
    times["P2"]["ms_roll"] = times.pop("P2 roll")["ms"]
    del x1d, data3d, x2

    # P3: 54 x 1024 slices, bf16 values (main: slab_u); P4: 55,296 units
    x2d, vals, lidx, m_slab, m_slab_a, m_sc = build_inputs(54, 1024, gen,
                                                           device=dev)
    y_bytes = 1024 * 8 * 128 * 4
    for variant, meta in metas_of(m_slab, m_slab_a, m_sc).items():
        use_lidx = P3[variant][1] == "lidx"
        nbytes = (vals.numel() * 2 + (lidx.numel() if use_lidx else 0)
                  + meta.numel() * 4 + x2d.numel() * 4 + y_bytes)
        row("P3" if variant == "slab_u" else f"P3 {variant}",
            f"P3 {variant}, bf16 values, 1024 tiles x 54 slices",
            lambda meta=meta, variant=variant: slab_slices(
                meta, x2d, vals, lidx, variant),
            lambda meta=meta, variant=variant: slab_slices_torch(
                meta, x2d, vals, lidx, *P3[variant]),
            nbytes, 2 * vals.numel(), None, "no library call")
    for variant in P3:
        if variant != "slab_u":
            times["P3"][f"ms_{variant}"] = times.pop(f"P3 {variant}")["ms"]
    del x2d, vals, lidx
    for sub in SUBS:
        n_tiles, x2d, lidx, meta = sub_inputs(55296, sub, gen, dev)
        v_t = draw_vals((n_tiles, 16, sub, 128), gen, dev).to(torch.bfloat16)
        for variant in P4:
            table, lane = P4[variant]
            nbytes = (v_t.numel() * 2 + (lidx.numel() if lane == "lidx"
                                         else 0)
                      + (0 if table == "none" else meta.numel() * 4
                         + x2d.numel() * 4) + n_tiles * sub * 128 * 4)
            key = "P4" if (sub, variant) == (8, "gather") else \
                f"P4 {sub} {variant}"
            row(key, f"P4 SUB {sub} {variant}, bf16 values, {n_tiles} tiles "
                f"x 16",
                lambda meta=meta, variant=variant: slab_slices_tall(
                    meta, x2d, v_t, lidx, variant),
                lambda meta=meta, variant=variant: slab_slices_torch(
                    meta, x2d, v_t, lidx, *P4[variant]),
                nbytes, (1 if table == "none" else 2) * v_t.numel(), None,
                "no library call")
        del x2d, lidx, v_t
    for key in [k for k in times if k.startswith("P4 ")]:
        _, sub, variant = key.split()
        t = times.pop(key)
        times["P4"][f"ms_sub{sub}_{variant}"] = t["ms"]
        times["P4"][f"bound_ms_sub{sub}_{variant}"] = t["bound_ms"]
    torch.cuda.empty_cache()
    print(f"[5g protos] phase wall {time.perf_counter() - t0:.1f} s | {gpu}")
    return launches, times


def phase6_bench(gpu, tmpdir: Path):
    """``python -m sparsebench_tpu_torch.bench`` (the full suite) as a
    subprocess: rc 0 and a final line of at most 1500 characters that
    parses, with a positive value, stream_read_GBps, dma_read_GBps,
    cg200_seconds and cg200_vmem_seconds; then its ``spmv 200
    dia,bslab,bsell`` mode, rc 0. Their output goes to ``tmpdir/bench.log``
    and ``tmpdir/bench_spmv.log`` and is echoed."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sparsebench_tpu_torch.bench"], cwd=REPO,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t
    (tmpdir / "bench.log").write_text(proc.stderr + proc.stdout)
    for line in proc.stderr.splitlines():
        print(f"[6 bench] {line}")
    lines = proc.stdout.strip().splitlines()
    check(proc.returncode == 0 and lines,
          f"the bench exited {proc.returncode}")
    last = json.loads(lines[-1])
    extra = last.get("extra", {})
    print(f"[6 bench] final line ({len(lines[-1])} characters): {lines[-1]}")
    print(f"[6 bench] python -m sparsebench_tpu_torch.bench: rc 0 in "
          f"{wall:.1f} s | {gpu}")
    check(len(lines[-1]) <= 1500, "the bench's final line is too long")
    check(last.get("value", 0) > 0 and all(
        extra.get(key, 0) > 0 for key in ("stream_read_GBps", "dma_read_GBps",
                                          "cg200_seconds",
                                          "cg200_vmem_seconds")),
        f"the bench's final line lacks a key: {lines[-1]}")
    argv = ["spmv", "200", "dia,bslab,bsell"]
    proc = subprocess.run(
        [sys.executable, "-m", "sparsebench_tpu_torch.bench", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    (tmpdir / "bench_spmv.log").write_text(proc.stderr + proc.stdout)
    for line in proc.stderr.splitlines():
        print(f"[6 bench spmv] {line}")
    print(f"[6 bench spmv] final line: {proc.stdout.strip()}")
    check(proc.returncode == 0 and "bsell: build" in proc.stderr,
          f"bench {' '.join(argv)} exited {proc.returncode}")
    return wall


def main() -> int:
    if not (REPO / "sparsebench_tpu_torch" / "csrc" / "dia_spmv.cu").is_file():
        print("chip_smoke: sparsebench_tpu_torch/ is not beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))

    # -- phase 1: fingerprint ----------------------------------------------
    gpu = gpu_fingerprint()
    print(f"[1 fingerprint] nvidia-smi: {gpu}")
    print(f"[1 fingerprint] python {sys.version.split()[0]} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    from sparsebench_tpu_torch import cli
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.base import physical_spmv_bytes
    from sparsebench_tpu_torch.formats.dia import DiaMatrix
    from sparsebench_tpu_torch.ops import _build
    from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv
    from sparsebench_tpu_torch.solvers.cg import init_vectors, solve_cg

    for name in PROTO_MODULES:  # held to the JAX-free check after phase 4f
        importlib.import_module(f"sparsebench_tpu_torch.benchmarks.{name}")
    print(f"[1 fingerprint] imports of the port took "
          f"{time.perf_counter() - t:.3f} s")
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    print(f"[1 fingerprint] {nvcc}: {nvcc_ver.splitlines()[-1]}")

    # -- phase 2: build -----------------------------------------------------
    t = time.perf_counter()
    libs = _build.build()
    for name in libs:
        _build.load_library(name)
    print(f"[2 build] {len(libs)} libraries built in parallel and loaded in "
          f"{time.perf_counter() - t:.2f} s")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[2 build] {name} ptxas: {line.strip()}")

    dev = torch.device("cuda")
    f32 = DTypePolicy.from_names("f32")
    f64 = DTypePolicy.from_names("f64")

    # -- phase 3: kernels against their plain versions ----------------------
    max_err = phase3_dia(dev)
    err_b, dots_rel = phase3b_stencil(dev)
    err_c, auto_c = phase3c_bslab(dev)
    err_d = phase3d_spmm(dev)
    err_e = phase3e_memroof(dev)
    err_f = phase3f_bsell(dev)
    err_g = phase3g_protos(dev)
    # the kernel auto picks for RGL (K6; K7 only when asked for)
    auto_kernel = "K7" if auto_c["RGL 2M"] == "kernel_win" else "K6"

    # -- phase 4: the main path through the CLI -----------------------------
    dia_spmv.launches = 0
    for argv in (["-t", "cg"], ["-f", str(REPO / "hpcg.par"), "-t", "cg"]):
        before = dia_spmv.launches
        k, diff = parse_cg(run_cli(cli.main, argv))
        n = dia_spmv.launches - before
        print(f"[4 main] {' '.join(argv)}: k={k} difference={diff} "
              f"kernel launches={n} | {gpu}")
        check(k == 150, f"{argv}: k={k}, expected 150")
        check(diff < F32_DIFF_BOUND,
              f"{argv}: difference {diff} >= {F32_DIFF_BOUND}")
        # warm-up + timed solve, each 1 + 149 SpMVs
        check(n >= 2 * 150, f"{argv}: only {n} kernel launches")
    before = dia_spmv.launches
    text = run_cli(cli.main, ["-t", "spmv"])
    n = dia_spmv.launches - before
    m = re.search(r"spMVM best per-iteration time: (\S+) ms", text)
    check(m is not None, "spmv output missing")
    check(n >= 150, f"-t spmv: only {n} kernel launches")
    print(f"[4 main] -t spmv: kernel launches={n}, reported per-SpMV time "
          f"{m.group(1)} ms | {gpu}")
    launches_main = dia_spmv.launches
    print(f"[4 main] kernel launches over the main path: {launches_main}")

    # f64 history at 100^3: kernel vs plain version
    A_k, counts = DiaMatrix.from_stencil(100, 100, 100, device=dev,
                                         policy=f64, impl="kernel")
    A_t, _ = DiaMatrix.from_stencil(100, 100, 100, device=dev, policy=f64,
                                    impl="torch")
    _x0, b, xexact = init_vectors(dtype=np.float64, row_lengths=counts)
    r_k = solve_cg(A_k, b, itermax=150, verbose=False)
    r_t = solve_cg(A_t, b, itermax=150, verbose=False)
    check(r_k.iterations == r_t.iterations, "f64 k differs")
    h_k, h_t = r_k.residual_history, r_t.residual_history
    sel = h_t >= NOISE_FLOOR * h_t[0]
    rel = float(np.max(np.abs(h_k[sel] - h_t[sel]) / h_t[sel]))
    print(f"[4 main] f64 100^3 history kernel vs plain: k={r_k.iterations}, "
          f"{int(sel.sum())} entries above the noise floor, max rel diff "
          f"{rel:.3e} (rtol {HIST_RTOL})")
    check(rel <= HIST_RTOL, "f64 residual history differs")
    x_err = float(np.max(np.abs(r_k.x - xexact)))
    print(f"[4 main] f64 100^3 max|x-1| through the kernel: {x_err:.3e}")
    check(x_err < F64_DIFF_BOUND, f"f64 max|x-1| {x_err} >= {F64_DIFF_BOUND}")
    del A_k, A_t

    # -- phase 4b: the stencil path through the CLI --------------------------
    launches_b = phase4b_stencil(cli, gpu)

    # -- phase 4c: the bslab path through the CLI ----------------------------
    tmpdir = REPO / "build" / "chip_smoke"
    tmpdir.mkdir(parents=True, exist_ok=True)
    launches_c = phase4c_bslab(cli, gpu, tmpdir, auto_kernel)

    # -- phase 4d: the solver family through the CLI -------------------------
    launches_d = phase4d_solvers(cli, gpu, tmpdir)

    # -- phase 4e: --profile and --banner through the CLI --------------------
    launches_e = phase4e_profile(cli, gpu)

    # -- phase 4f: the bsell path through the CLI ----------------------------
    launches_f = phase4f_bsell(cli, gpu)
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "sparsebench_tpu"))
    check(not jax_mods, f"the port imported JAX or the JAX package: "
          f"{jax_mods[:5]}")
    check(all(f"sparsebench_tpu_torch.benchmarks.{m}" in sys.modules
              for m in PROTO_MODULES), "the prototype modules were not "
          "imported before the check")
    print("[4e profile] no module of JAX or of the JAX package was imported "
          "(the port's prototype modules included)")

    # -- phase 5: times of K1 -----------------------------------------------
    timing = {}
    for n in (100, 200):
        A_k, counts = DiaMatrix.from_stencil(n, n, n, device=dev, policy=f32,
                                             impl="kernel")
        A_t, _ = DiaMatrix.from_stencil(n, n, n, device=dev, policy=f32,
                                        impl="torch")
        x = torch.ones(A_k.nc, dtype=torch.float32, device=dev)
        k_ms, p_ms, ms, eager = time_pair(lambda: A_k.spmv(x),
                                          lambda: A_t.spmv(x))
        phys = physical_spmv_bytes(A_k, 4)
        csr = dia_to_csr(A_k)
        lib_err = float((csr @ x - A_k.spmv(x)).abs().max())
        lib_ms = min(time_graph(lambda: csr @ x) for _ in range(2))
        del csr
        _x0, b, _xe = init_vectors(dtype=np.float32, row_lengths=counts)
        solve = {w: solve_cg(A, b, itermax=150, verbose=False).solve_seconds
                 for w, A in (("kernel", A_k), ("plain", A_t))}
        b_ms, b_by = bound(phys, 2 * A_k.nnz)
        timing[n] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, eager_ms=eager)
        print(f"[5 times] {n}^3 f32 (bf16 diagonals): SpMV kernel "
              f"{ms['kernel']} ms, plain {ms['plain']} ms (graph replay); "
              f"kernel eager {eager:.6f} ms; physical "
              f"{phys} B -> kernel {phys / (k_ms * 1e-3) / 1e9:.1f} GB/s, "
              f"plain {phys / (p_ms * 1e-3) / 1e9:.1f} GB/s; bound "
              f"{b_ms:.6f} ms ({b_by}); cuSPARSE CSR f32 {lib_ms:.6f} ms "
              f"(max|csr - kernel| {lib_err:.3e}) | {gpu}")
        print(f"[5 times] {n}^3 f32 CG x150 solve: kernel "
              f"{solve['kernel']:.6f} s, plain {solve['plain']:.6f} s | {gpu}")
        del A_k, A_t, x

    # -- phase 5b: times of K2-K5 and the stencil variants -------------------
    times_b = phase5b_times(dev, gpu)
    stencil_cg_seconds(dev, gpu)

    # -- phase 5c: times of K6 and K7 and the bslab CG -----------------------
    times_c = phase5c_times(dev, gpu)

    # -- phase 5d: times of K8, blocked CG and the solver family -------------
    times_d = phase5d_times(dev, gpu)

    # -- phase 5e: the read ceiling K12 ---------------------------------------
    launches_k12, times_e = phase5e_memroof_times(dev, gpu)

    # -- phase 5f: times of K9-K11 and the bsell CG ---------------------------
    times_f = phase5f_times(dev, gpu)

    # -- phase 5g: the prototype modules (P1-P5) and their kernels' times ---
    launches_g, times_g = phase5g_protos(dev, gpu, tmpdir, timing[200])

    # -- phase 6: the bench suite -------------------------------------------
    phase6_bench(gpu, tmpdir)

    src = "sparsebench_tpu_torch/csrc/"

    def row(name, route_src, replaces, launches, err, t100, t200=None):
        r = {"name": name, "route": "cuda", "source": src + route_src,
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             **t100}
        if t200 is not None:
            r.update({f"{k}_200": v for k, v in t200.items()
                      if k != "library_ms" or v is not None})
        return r

    kernels = [
        row("dia_spmv", "dia_spmv.cu", "sparsebench_tpu/ops/dia_pallas.py:454",
            launches_main, max_err, timing[100], timing[200]),
        row("stencil_apply", "stencil.cu",
            "sparsebench_tpu/ops/stencil_pallas.py:292",
            launches_b["K2"] + launches_b["K2 dots"], err_b["K2"],
            times_b["K2"][100], times_b["K2"][200]),
        row("stencil_axpy_apply_dots", "stencil.cu",
            "sparsebench_tpu/ops/stencil_pallas.py:457", launches_b["K3"],
            err_b["K3"], times_b["K3"][100], times_b["K3"][200]),
        row("cs_update", "cg_fused.cu", "sparsebench_tpu/ops/cg_fused.py:59",
            launches_b["K4"], err_b["K4"], times_b["K4"][100],
            times_b["K4"][200]),
        row("stencil_cg_vmem", "stencil_cg_vmem.cu",
            "sparsebench_tpu/ops/stencil_cg_vmem.py:274", launches_b["K5"],
            err_b["K5"], times_b["K5"][100], times_b["K5"][200]),
    ]
    for name, key, line in (("bslab_spmv", "K6", 242),
                            ("bslab_spmv_win", "K7", 318)):
        # the main numbers at RGL 2M, the slice's own workload; the
        # generated stencil's beside them (K7's window does not fit 200^3)
        r = {"name": name, "route": "cuda", "source": src + "bslab_spmv.cu",
             "replaces": f"sparsebench_tpu/ops/bslab_pallas.py:{line}",
             "launches": launches_c[key], "max_abs_err": err_c[key],
             **times_c[key]["rgl"]}
        for case in ("100", "200"):
            r.update({f"{k}_{case}": v
                      for k, v in times_c[key].get(case, {}).items()})
        kernels.append(r)
    kernels.append(row("dia_spmm", "dia_spmm.cu",
                       "sparsebench_tpu/ops/dia_pallas.py:248", launches_d,
                       err_d, times_d[100], times_d[200]))
    kernels.append(row("read_passes", "memroof.cu",
                       "sparsebench_tpu/ops/memroof.py:67", launches_k12,
                       err_e, times_e))
    for name, key, line in (("bsell_spmv", "K9", 131),
                            ("bsell_spmv_win2", "K10", 200),
                            ("bsell_spmv_windowed", "K11", 240)):
        # the main numbers at 100^3 through the CLI's host CSR build, the
        # slice's own path; the device builds' beside them (K10/K11's
        # window does not fit 200^3)
        r = {"name": name, "route": "cuda", "source": src + "bsell_spmv.cu",
             "replaces": f"sparsebench_tpu/ops/bsell_pallas.py:{line}",
             "launches": launches_f[key], "max_abs_err": err_f[key],
             **times_f[key]["100"]}
        for case in ("100s", "200"):
            r.update({f"{k}_{case}": v
                      for k, v in times_f[key].get(case, {}).items()})
        kernels.append(r)
    for key, name, replaces, route_src in (
            ("P5", "pass1_products", "csr_twopass_proto.py:207",
             "csr_twopass.cu"),
            ("P1", "dia_window", "dia_micro.py:162", "dia_window.cu"),
            ("P2", "dia_shear", "dia_shear.py:108", "dia_window.cu"),
            ("P3", "slab_slices", "slab_micro.py:111", "slab_slices.cu"),
            ("P4", "slab_slices_tall", "slab_micro2.py:70", "slab_slices.cu")):
        kernels.append(row(name, route_src, f"benchmarks/{replaces}",
                           launches_g[key], err_g[key], times_g[key]))
    kernels[0]["launches_profile"] = launches_e
    kernels[1]["launches_dots_form"] = launches_b["K2 dots"]
    kernels[1]["dots_max_rel_err"] = dots_rel["K2"]
    kernels[2]["dots_max_rel_err"] = dots_rel["K3"]
    # each byte-bound kernel's rate as a share of the data sheet's 3.35 TB/s
    # and of the read ceiling K12 measured in phase 5e
    ceiling = times_e["dma_read_GBps"] * 1e9
    for r in kernels:
        for case in ("", "_100", "_100s", "_200"):
            ms, b_ms = r.get("ms" + case), r.get("bound_ms" + case)
            if ms is None or r.get("bound_by" + case) != "bytes":
                continue
            r["ceiling_share" + case] = b_ms * HBM_BYTES_PER_S / (ms * ceiling)
            print(f"[5e K12] {r['name']}{case or ' (main case)'}: "
                  f"{b_ms / ms:.3f} of 3.35 TB/s, "
                  f"{r['ceiling_share' + case]:.3f} of the read ceiling "
                  f"{ceiling / 1e9:.1f} GB/s | {gpu}")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
