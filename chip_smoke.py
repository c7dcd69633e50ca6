#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (sparsebench_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. fingerprint: nvidia-smi name and power limit, torch / CUDA / nvcc versions;
2. build: compile csrc/*.cu with nvcc for sm_90a (timed);
3. kernel against its plain version on the card: the DIA SpMV kernel vs
   dia_spmv_torch for (bf16, f32), (f32, f32) and (f64, f64) on the
   generated stencil at 10x9x7, 100^3 and 200^3, on
   tests/data/matrix_band_klein.mtx and on synthetic edge offsets;
4. main path: the CLI as a user runs it (``-t cg`` at 100^3, ``-f hpcg.par
   -t cg`` at 200^3, ``-t spmv``), with the kernel launch count read around
   those runs; then the f64 residual history at 100^3 through the kernel
   against the plain version;
5. times: CG solve seconds and per-SpMV milliseconds of the kernel and the
   plain version at 100^3 and 200^3, with physical GB/s.

The last two lines are a JSON object of the kernels and the result line
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout, the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# f32 CG on the generated problem reaches max|x - 1| of about 1e-6 to 2e-6
# at 100^3 and 200^3 after 150 iterations (the JAX package reports the
# same); the CLI prints it with 6 decimals. Bound with headroom:
F32_DIFF_BOUND = 1e-5
# f64 CG at 100^3 drives the residual below 1e-10 of its start well
# before 150 iterations; max|x - 1| far below this bound
F64_DIFF_BOUND = 1e-8
# f64 history through the kernel vs the plain version: entries above the
# rounding-noise floor (1e-10 of the initial residual) agree to rtol 1e-9
NOISE_FLOOR = 1e-10
HIST_RTOL = 1e-9
SPMV_TIMING_REPS = 50


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


def time_spmv(fn, x, reps: int) -> float:
    """Milliseconds per call of ``fn(x)`` over ``reps`` back-to-back calls,
    timed with CUDA events after a warm-up."""
    import torch

    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    from sparsebench_tpu_torch.host import read_mm
    from sparsebench_tpu_torch.ops import _build
    from sparsebench_tpu_torch.ops.dia_spmv import dia_spmv, dia_spmv_torch
    from sparsebench_tpu_torch.solvers.cg import init_vectors, solve_cg

    print(f"[1 fingerprint] imports of the port took "
          f"{time.perf_counter() - t:.3f} s")
    nvcc = _build.find_nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    print(f"[1 fingerprint] {nvcc}: {nvcc_ver.splitlines()[-1]}")

    # -- phase 2: build -----------------------------------------------------
    t = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"[2 build] {lib_path.name} built and loaded in "
          f"{time.perf_counter() - t:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[2 build] ptxas: {line.strip()}")

    dev = torch.device("cuda")
    f32 = DTypePolicy.from_names("f32")
    f64 = DTypePolicy.from_names("f64")

    # -- phase 3: kernel against the plain version ---------------------------
    # The kernel rounds every product and sum (no FMA contraction) and sums
    # the diagonals in the plain version's order, so the two are expected
    # to agree bit for bit. The stated tolerance is the forward error bound
    # of any ordering of an ndiag-term sum with or without contraction:
    # |y_kernel - y_plain| <= ndiag * eps(x dtype) * (|A| |x|)_i.
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
            bound = dia_spmv_torch(data.abs(), x.abs(), offsets, nr)
            torch.cuda.synchronize()
            tol = len(offsets) * torch.finfo(tx).eps
            err = (y_k - y_p).abs()
            ok = bool(torch.isfinite(y_k).all()) and bool(
                (err <= tol * bound).all())
            e = float(err.max())
            max_err = max(max_err, e)
            td_name = str(td).removeprefix("torch.")
            tx_name = str(tx).removeprefix("torch.")
            print(f"[3 kernel] {name} data {td_name} x {tx_name}: "
                  f"max|kernel-plain| {e:.3e} (bound {tol:.2e}*(|A||x|)_i)"
                  f" {'ok' if ok else 'FAIL'}")
            check(ok, f"kernel disagrees with the plain version on {name}")
    del cases, data, data0, A

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
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "sparsebench_tpu"))
    check(not jax_mods, f"the port imported JAX or the JAX package: "
          f"{jax_mods[:5]}")
    print("[4 main] no module of JAX or of the JAX package was imported")

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

    # -- phase 5: times -------------------------------------------------------
    timing = {}
    for n in (100, 200):
        A_k, counts = DiaMatrix.from_stencil(n, n, n, device=dev, policy=f32,
                                             impl="kernel")
        A_t, _ = DiaMatrix.from_stencil(n, n, n, device=dev, policy=f32,
                                        impl="torch")
        x = torch.ones(A_k.nc, dtype=torch.float32, device=dev)
        ms = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            A = A_t if which == "plain" else A_k
            ms[which].append(time_spmv(A.spmv, x, SPMV_TIMING_REPS))
        phys = physical_spmv_bytes(A_k, 4)
        _x0, b, _xe = init_vectors(dtype=np.float32, row_lengths=counts)
        solve = {w: solve_cg(A, b, itermax=150, verbose=False).solve_seconds
                 for w, A in (("kernel", A_k), ("plain", A_t))}
        k_ms = min(ms["kernel"])
        p_ms = min(ms["plain"])
        timing[n] = (k_ms, p_ms)
        print(f"[5 times] {n}^3 f32 (bf16 diagonals): SpMV kernel "
              f"{ms['kernel']} ms, plain {ms['plain']} ms; physical "
              f"{phys} B -> kernel {phys / (k_ms * 1e-3) / 1e9:.1f} GB/s, "
              f"plain {phys / (p_ms * 1e-3) / 1e9:.1f} GB/s | {gpu}")
        print(f"[5 times] {n}^3 f32 CG x150 solve: kernel "
              f"{solve['kernel']:.6f} s, plain {solve['plain']:.6f} s | {gpu}")
        del A_k, A_t, x

    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "dia_spmv",
        "route": "cuda",
        "source": "sparsebench_tpu_torch/csrc/dia_spmv.cu",
        "replaces": "sparsebench_tpu/ops/dia_pallas.py:454",
        "launches": launches_main,
        "max_abs_err": max_err,
        "ms": timing[100][0],
        "plain_ms": timing[100][1],
        "ms_200": timing[200][0],
        "plain_ms_200": timing[200][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
