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
4. main path: the CLI as a user runs it (``-t cg`` at 100^3, ``-f hpcg.par
   -t cg`` at 200^3, ``-t spmv``), with the kernel launch count set to 0
   before and read after those runs; then the f64 residual history at 100^3
   through the kernel against the plain version;
4b. the stencil path: ``--fmt stencil -t cg`` with each CG variant at 100^3
   and (but vmem, which must refuse there) at 200^3, ``cs`` with
   SB_FUSED_CS=1, and ``-t spmv --fmt stencil``, with every stencil
   kernel's launch count set to 0 before and read after;
5. times: CG solve seconds and per-SpMV milliseconds of K1 and its plain
   version at 100^3 and 200^3, with physical GB/s, beside the same product
   as a cuSPARSE CSR SpMV (torch.sparse_csr_tensor @ x);
5b. times of K2-K5 beside their plain versions, their bounds and, for K2,
   torch.nn.functional.conv3d; CG x150 seconds of each stencil variant.

A bound is the larger of the bytes a call must move (each input read once,
each output written once) over 3.35 TB/s and its operations over
67 TFLOP/s (f32), the H100 SXM's published rates at 700 W. The last three
lines are the card's name and power limit, a JSON object of the kernels and
the result line ``{"ok": true, "device": {...}}``. Without CUDA, or outside
a checkout, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
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
    runs = [(100, v, False) for v in VARIANTS] + [
        (200, v, False) for v in VARIANTS[:3]] + [(100, "cs", True)]
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
    # vmem at 200^3 does not fit the L2 plan and must refuse, loudly
    try:
        run_cli(cli.main, ["-f", str(REPO / "hpcg.par"), "-t", "cg",
                           "--fmt", "stencil", "--cg-variant", "vmem"])
        check(False, "vmem at 200^3 ran; it must refuse")
    except SystemExit as e:
        check("not viable at 200x200x200" in str(e),
              f"vmem at 200^3 refused with another message: {e}")
        print(f"[4b stencil] 200^3 vmem refused: {e}")
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
    return launches


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
            if n == 200 and variant == "vmem":
                continue  # refused: r and p do not fit the L2 plan
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
    # K5: one whole solve at 100^3 f32, 150 iterations
    b = torch.from_numpy((27.0 - (stencil_row_counts(100, 100, 100) - 1.0))
                         .astype(np.float32)).to(dev)
    x0 = torch.zeros_like(b)
    r0 = b - stencil_apply(x0, 100, 100, 100)
    _x, hist = stencil_cg_vmem(r0, x0, 0.0, 100, 100, 100, 150)
    iters = int(torch.sum(~torch.isnan(hist))) - 1
    # eager: the plain version reads scalars on the host each iteration,
    # and one launch of the kernel takes milliseconds
    k_ms, p_ms, all_ms, eager = time_pair(
        lambda: stencil_cg_vmem(r0, x0, 0.0, 100, 100, 100, 150),
        lambda: stencil_cg_vmem_torch(r0, x0, 0.0, 100, 100, 100, 150),
        graph=False, reps=3)
    pts = 100 ** 3
    b_ms, b_by = bound(3 * 4 * pts, (2 + K5_FLOPS_PER_ITER * iters) * pts)
    out["K5"][100] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None, eager_ms=eager)
    print(f"[5b times] K5 whole CG solve 100^3 f32 x150 ({iters} iterations "
          f"run): kernel {all_ms['kernel']} ms, plain {all_ms['plain']} ms; "
          f"bound {b_ms:.6f} ms ({b_by}: r0 and x0 read, x written once; "
          f"{K5_FLOPS_PER_ITER} flops a point an iteration) | {gpu}")
    return out


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
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "sparsebench_tpu"))
    check(not jax_mods, f"the port imported JAX or the JAX package: "
          f"{jax_mods[:5]}")
    print("[4b stencil] no module of JAX or of the JAX package was imported")

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
            err_b["K5"], times_b["K5"][100]),
    ]
    kernels[1]["launches_dots_form"] = launches_b["K2 dots"]
    kernels[1]["dots_max_rel_err"] = dots_rel["K2"]
    kernels[2]["dots_max_rel_err"] = dots_rel["K3"]
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
