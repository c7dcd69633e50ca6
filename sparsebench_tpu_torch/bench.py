"""Headline benchmark suite of the port: one JSON line on stdout (the
counterpart of the repository's root bench.py, which runs the JAX package).

    python -m sparsebench_tpu_torch.bench [--device cuda|cpu] [--small]
    python -m sparsebench_tpu_torch.bench [--device ...] cg [n]
    python -m sparsebench_tpu_torch.bench [--device ...] spmv [n] [fmts]

No argument runs the full suite at its published sizes; ``cg`` times CG on
the n^3 stencil as DIA (default 100), ``spmv`` the SpMV of each format of
``fmts`` (comma-separated, default dia,bslab) on it. ``--device cpu`` runs
the plain PyTorch path on the host clock, for the tests; its numbers are
the CPU's, and the line says so. ``--small`` runs every section at a test
size. Diagnostics go to stderr; stdout carries only the JSON line(s).

Headline metric: CG time-to-solution on the reference's default workload
(27-point stencil, 100^3, 150 iterations; src/parameter.c:14-19), the best
of DIA standard and cs, bslab cs and the matrix-free stencil's variants.
``vs_baseline`` is null: the C reference's 6.41 s that the JAX bench
divides by was timed on another host, and the reference has not been timed
on this card's host.

The ``extra`` dict, under the JAX bench's key names:
  kernel_build_seconds  nvcc build of every csrc/*.cu (ops/_build.py), the
                        port's analog of the JAX bench's compile cache; 0
                        when the libraries were already built
  stream_triad_GBps     in-situ STREAM triad, a = b + s*a (3 arrays a pass)
  stream_read_GBps      read-only stream: torch.sum over the array
  dma_read_GBps         the read kernel K12 (ops/memroof.py): every element
                        read ``reps`` times in one launch
  spmv_GBps, spmv200_GBps   effective DIA SpMV bandwidth, reference byte
                        model ((value + index) bytes per nonzero,
                        src/main.c:187-189)
  *_phys_GBps           PHYSICAL bandwidth: every stored array at its
                        stored dtype, padding included, plus x read and y
                        written (formats/base.py physical_spmv_bytes)
  *_spread              (worst - best) / best of the t_hi trials
  spmv_frac_of_stream   best physical rate / the roofline denominator:
                        the detected card's data-sheet HBM rate and every
                        measured ceiling at or below it (an unknown card:
                        the measured ceilings alone)
  cg200_seconds         CG 150 iterations on hpcg.par's 200^3 workload
  cg200_vmem_seconds    the same with the whole-solve vmem CG (K5), valid
                        only with k = 150 and max|x - 1| < 1e-5
  setup*_seconds        the first build in the process; *_build_seconds a
                        second, warm build; *_compile_seconds the
                        difference (first-use costs: allocator growth and
                        the like; nothing is compiled at setup)
  {gmres,bicgstab,minres,cheb}100_*   the solver family at 100^3
  cg100_nrhs8_speedup   8 x one single-RHS solve / the k = 8 blocked solve,
                        both in this run

Timing: a CG solve's seconds are ``solve_cg``'s (host clock around the
timed solve, closed by a synchronise, after its warm-up); the streams, K12
and the SpMV chains are timed with CUDA events, as the differential
(t(3r) - t(r)) / 2r of r and 3r chained calls, the slower of two such
estimates. A section that raises or gives an invalid result is logged; the
suite still prints its line, and exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from sparsebench_tpu_torch.config import DTypePolicy, resolve_device, synchronize
from sparsebench_tpu_torch.utils import elapsed_seconds, nvidia_smi

TARGET_FRACTION = 0.70
REPO = Path(__file__).resolve().parent.parent

# Data-sheet HBM rates (GB/s) by a part of torch.cuda.get_device_name: NVIDIA's
# H100 SXM5 80 GB HBM3 (3.35 TB/s) and H200 (4.8 TB/s) data sheets
NOMINAL_HBM_GBPS = (
    ("H100 80GB HBM3", 3350.0),
    ("H200", 4800.0),
)

# Final-line budget: a reader that keeps only the tail of the output finds
# the last line whole when it is at most this long.
_TAIL_BUDGET = 1500

# Priority order for extras kept on the compact final line when the full
# payload overflows (the root bench.py's order, kept equal by a test).
_COMPACT_PRIORITY = (
    "stream_triad_GBps", "stream_read_GBps",
    "spmv_frac_of_stream", "spmv_effective_frac_of_stream",
    "spmv_general_phys_frac_of_stream",
    "cg100_fused_seconds", "cg100_vmem_seconds", "cg100_variant",
    "cg200_seconds", "cg200_vmem_seconds", "cg200_variant",
    "setup200_warm_process_seconds", "compile_cache_hit",
    "setup200_cold_process_seconds",
    "setup200_bslab_compile_seconds", "setup200_bslab_build_seconds",
    "spmv200_bslab_phys_GBps", "spmv200_GBps", "spmv200_phys_GBps",
    "spmv100_sell_phys_GBps", "sell_vs_bslab_ratio",
    "cg100_nrhs8_per_rhs_seconds", "cg100_nrhs8_speedup",
    "rgl_spmv_GBps", "rgl_phys_frac_of_stream", "csrseg_GBps",
    "gmres100_jacobi_iters_to_1e8", "gmres100_jacobi_final_normr",
    "gmres100_cheb_iters_to_1e8", "gmres100_cheb_seconds",
    "gmres100_final_normr", "gmres100_seconds",
    "bicgstab100_seconds", "minres100_seconds", "cheb100_seconds",
    "setup100_seconds", "setup100_compile_seconds", "cg100_7pt_seconds",
)

# the compact line's order: the JAX bench's, with the port's third ceiling
# (K12, which the JAX bench never emitted) after the two STREAM ceilings
_EMIT_ORDER = (*_COMPACT_PRIORITY[:2], "dma_read_GBps",
               *_COMPACT_PRIORITY[2:])

# a differential must span at least this long (auto-scaled chain length)
MIN_DIFF_S = 0.030


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(payload: dict, rc: int) -> int:
    """Print the JSON payload; where it is longer than ``_TAIL_BUDGET``,
    follow it with a compact line that keeps every top-level key and as
    many extras as fit, in ``_EMIT_ORDER``, so that the final line always
    parses within the budget. Returns ``rc``."""
    full_line = json.dumps(payload)
    print(full_line, flush=True)
    if len(full_line) > _TAIL_BUDGET and "extra" in payload:
        compact = {k: v for k, v in payload.items() if k != "extra"}
        extra = payload["extra"]
        kept: dict = {}
        ordered = list(_EMIT_ORDER) + [
            k for k in extra if k not in _EMIT_ORDER]
        for k in ordered:
            if k not in extra:
                continue
            trial = dict(kept)
            trial[k] = extra[k]
            line = json.dumps({**compact, "extra": trial,
                               "extra_dropped": 999})
            if len(line) > _TAIL_BUDGET:
                break
            kept = trial
        compact["extra"] = kept
        dropped = len(extra) - len(kept)
        if dropped:
            compact["extra_dropped"] = dropped
        print(json.dumps(compact), flush=True)
    return rc


# -- ceilings -------------------------------------------------------------


def nominal_hbm_gbps(device_name: str) -> Optional[float]:
    """The data-sheet HBM rate of a card by its name, or None for a card
    not in ``NOMINAL_HBM_GBPS``."""
    for part, gbps in NOMINAL_HBM_GBPS:
        if part in device_name:
            return gbps
    return None


def roofline_denominator(*measured: Optional[float],
                         nominal: Optional[float]):
    """(roof, excluded_any) for the physical-fraction denominator: the
    largest of the nominal rate and the measured ceilings at or below
    1.02 x nominal. A measured ceiling above the pin rate is a timing
    artifact, not a ceiling, and is left out (``excluded_any``). Without a
    nominal rate (an unknown card) the measured ceilings alone count."""
    vals = [v for v in measured if v is not None]
    if nominal is None:
        return (max(vals) if vals else None), False
    ok = [v for v in vals if v <= nominal * 1.02]
    return max([nominal, *ok]), len(ok) < len(vals)


def _differential(run, n: int, device, trials: int) -> float:
    """Seconds a call from the best of ``trials`` timings of ``run(n)``
    and of ``run(3n)``: (t_hi - t_lo) / 2n, or t_hi / 3n where noise makes
    it non-positive."""
    t_lo = min(elapsed_seconds(lambda: run(n), device) for _ in range(trials))
    t_hi = min(elapsed_seconds(lambda: run(3 * n), device)
               for _ in range(trials))
    dt = (t_hi - t_lo) / (2 * n)
    return dt if dt > 0 else t_hi / (3 * n)


def measure_stream_triad(n_floats: int = 64 * 1024 * 1024, iters: int = 20,
                         trials: int = 3, device="cuda") -> float:
    """STREAM triad in GB/s: a = b + 0.999 a, one ``torch.add`` a pass
    (read a, read b, write a: 12 bytes an element); the slower of two
    differential estimates."""
    a = torch.ones(n_floats, dtype=torch.float32, device=device)
    b = torch.full((n_floats,), 0.5, dtype=torch.float32, device=device)

    def run(n):
        for _ in range(n):
            torch.add(b, a, alpha=0.999, out=a)

    run(iters)
    run(3 * iters)  # warm-up
    dt = max(_differential(run, iters, device, trials) for _ in range(2))
    return 3.0 * 4.0 * n_floats / dt / 1e9


def measure_stream_read(n_floats: int = 64 * 1024 * 1024, iters: int = 20,
                        trials: int = 3, device="cuda") -> float:
    """Read-only stream in GB/s: ``torch.sum`` over an f32 array, one pass
    a call (4 bytes read an element; eager calls are never hoisted out of
    the loop, so no carry is needed); the slower of two differential
    estimates."""
    a = torch.ones(n_floats, dtype=torch.float32, device=device)

    def run(n):
        for _ in range(n):
            torch.sum(a)

    run(iters)
    run(3 * iters)
    dt = max(_differential(run, iters, device, trials) for _ in range(2))
    return 4.0 * n_floats / dt / 1e9


# -- the measured pieces --------------------------------------------------


def _dtype_name(v) -> str:
    """f32, f64 or bf16 for a numpy array or a tensor."""
    name = str(v.dtype).replace("torch.", "")
    return {"float32": "f32", "float64": "f64",
            "bfloat16": "bf16"}.get(name, name)


def _setup_times(build, device):
    """(result of the second build, {"cold", "build", "compile"}): the
    first build in the process, a second (warm) one, and the difference."""
    t0 = time.perf_counter()
    build()
    synchronize(device)
    cold = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = build()
    synchronize(device)
    warm = time.perf_counter() - t1
    return out, {"cold": cold, "build": warm,
                 "compile": max(cold - warm, 0.0)}


def build_stencil_dia(n: int, device, policy: DTypePolicy):
    """The n^3 stencil built into DIA on the device (bf16 diagonals) twice
    (``_setup_times``), and its vectors. Returns (A, b, xexact, setup)."""
    from sparsebench_tpu_torch.formats.dia import DiaMatrix
    from sparsebench_tpu_torch.solvers.cg import init_vectors

    (A, counts), setup = _setup_times(
        lambda: DiaMatrix.from_stencil(n, n, n, device=device, policy=policy),
        device)
    log(f"{n}^3 setup (analytic dia): cold {setup['cold']:.3f}s, warm "
        f"{setup['build']:.3f}s, {A.nnz} nnz, impl={A.impl}")
    _x0, b, xexact = init_vectors(row_lengths=counts, dtype=np.float32)
    return A, b, xexact, setup


def timed_cg(A, b, xexact, n: int, itermax: int = 150, attempts: int = 3,
             variant: str = "standard", diff_tol: float = 1e-3,
             full_k: bool = False):
    """Best validated CG solve seconds, scaled to ``itermax`` iterations
    where the breakdown guard ended it early, or None if every attempt was
    invalid. ``diff_tol`` is the max|x - xexact| bar (bf16 reaches about
    0.02). With ``full_k`` an early end is invalid unless the residual
    reached exactly 0 (a test-size grid solved exactly)."""
    from sparsebench_tpu_torch.solvers.cg import check_residual, solve_cg

    tag = f"{variant}, {_dtype_name(b)}, tol {diff_tol:g}"
    best, good = float("inf"), False
    for _ in range(attempts):
        res = solve_cg(A, b, itermax=itermax, eps=0.0, verbose=False,
                       variant=variant)
        err = check_residual(res.x, xexact)
        ok = (bool(np.isfinite(res.residual_history).all()) and err < diff_tol
              and (res.iterations == itermax or res.final_normr == 0
                   or not full_k))
        t = res.solve_seconds * itermax / max(res.iterations, 1)
        scaled = (f" -> {t:.4f}s @{itermax}" if res.iterations != itermax
                  else "")
        log(f"  cg {n}^3 [{tag}]: {res.solve_seconds:.4f}s "
            f"({res.iterations} iters{scaled}, final residual "
            f"{res.final_normr:.2e}, max|x-1| {err:.2e}, "
            f"{'ok' if ok else 'INVALID'})")
        if ok:
            best = min(best, t)
            good = True
    return best if good else None


def phys_gbps(A, dt: float, x_bytes: int = 4) -> float:
    """Physical bandwidth: the bytes an SpMV streams / time."""
    from sparsebench_tpu_torch.formats.base import physical_spmv_bytes

    return physical_spmv_bytes(A, x_bytes) / dt / 1e9


def spmv_chain_stats(A, reps: int = 30, trials: int = 4,
                     min_diff_s: float = MIN_DIFF_S):
    """(seconds per SpMV, spread) from a chain of SpMVs, y fed back as x
    (f32), timed with CUDA events: the differential (t(3r) - t(r)) / 2r,
    with r raised until the differential spans ``min_diff_s``, the slower
    of two estimates; spread = (worst - best) / best over the t(3r) trials
    of the final estimate."""
    device = A.device
    permuted = getattr(A, "permuted_output", False)

    def step(u):
        if permuted:
            return A.spmv_permuted(u)
        y = A.spmv(u)
        if y.shape[0] == A.nc:
            return y
        return torch.cat([y, u[y.shape[0]:]])

    carry = torch.ones(A.nc, dtype=torch.float32, device=device)

    def run(n):
        u = carry
        for _ in range(n):
            u = step(u)
        return u

    run(reps)
    run(3 * reps)  # warm-up

    def differential(r):
        t_lo = min(elapsed_seconds(lambda: run(r), device)
                   for _ in range(trials))
        t_hi_all = [elapsed_seconds(lambda: run(3 * r), device)
                    for _ in range(trials)]
        t_hi, t_hi_worst = min(t_hi_all), max(t_hi_all)
        dt = (t_hi - t_lo) / (2 * r)
        if dt <= 0:
            dt = t_hi / (3 * r)
        spread = (t_hi_worst - t_hi) / t_hi if t_hi > 0 else 0.0
        return dt, spread

    dt, spread = differential(reps)
    if 2 * reps * dt < min_diff_s:  # too fast for this chain length
        reps = max(reps, int(min_diff_s / max(2 * dt, 1e-9)) + 1)
        run(3 * reps)
        dt, spread = differential(reps)
    dt2, spread2 = differential(reps)
    return max(dt, dt2), max(spread, spread2)


def spmv_chain_time(A, reps: int = 30, trials: int = 4) -> float:
    """Seconds per SpMV of ``spmv_chain_stats``."""
    return spmv_chain_stats(A, reps=reps, trials=trials)[0]


# -- the suite ------------------------------------------------------------


@dataclasses.dataclass
class Sizes:
    """The sections' problem sizes: published (the defaults) or ``small``
    for the tests."""

    n100: int = 100
    n200: int = 200
    rgl_n: int = 2_000_000
    stream_floats: int = 64 * 1024 * 1024
    dma_floats: int = 64 * 1024 * 1024
    dma_tile_rows: int = 2048

    @classmethod
    def small(cls) -> "Sizes":
        """Test sizes. The read ceiling's array is one tile: the CPU's
        plain K12 takes one step a tile, and at 8-row tiles its rate sat
        near the 0.1 GB/s the line rounds to."""
        return cls(n100=8, n200=10, rgl_n=4096, stream_floats=1 << 14,
                   dma_floats=1 << 14, dma_tile_rows=128)


@dataclasses.dataclass
class Suite:
    """State the sections share: the device and sizes, the ``extra``
    dict, the failures so far, the ceilings and the best 100^3 CG time,
    and the 100^3 DIA problem that several sections reuse."""

    device: torch.device
    sizes: Sizes = dataclasses.field(default_factory=Sizes)
    extra: dict = dataclasses.field(default_factory=dict)
    failures: List[str] = dataclasses.field(default_factory=list)
    nominal: Optional[float] = None
    stream: Optional[float] = None   # the triad ceiling, unrounded
    read_bw: Optional[float] = None  # torch.sum's, unrounded
    dma: Optional[float] = None      # K12's, unrounded
    roof: Optional[float] = None
    best100: Optional[float] = None
    dia100: Optional[tuple] = None  # (A, b, xexact)
    policy: DTypePolicy = dataclasses.field(
        default_factory=lambda: DTypePolicy.from_names("f32", "i32"))

    @contextlib.contextmanager
    def part(self, name: str):
        """Run a section or a part of one: an exception is logged and
        recorded as a failure, and the suite goes on."""
        try:
            yield
        except Exception as e:  # noqa: BLE001 — logged, counted, rc 1
            self.fail(f"{name} failed: {e!r}")

    def fail(self, msg: str) -> None:
        log(msg)
        self.failures.append(msg)

    def take100(self, t: Optional[float], variant: str) -> None:
        if t is not None and (self.best100 is None or t < self.best100):
            self.best100 = t
            self.extra["cg100_variant"] = variant


def section_build(s: Suite) -> None:
    """nvcc build of every kernel library (CUDA only)."""
    if s.device.type != "cuda":
        return
    from sparsebench_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    s.extra["kernel_build_seconds"] = round(time.perf_counter() - t0, 2)
    log(f"kernel build: {len(libs)} libraries in "
        f"{s.extra['kernel_build_seconds']} s (0 when already built)")


def section_ceilings(s: Suite) -> None:
    """1. In-situ read and triad ceilings, K12's among them, and the
    roofline denominator."""
    from sparsebench_tpu_torch.ops.memroof import measure_dma_read_gbps

    z = s.sizes
    stream = measure_stream_triad(z.stream_floats, device=s.device)
    s.stream = stream
    s.extra["stream_triad_GBps"] = round(stream, 1)
    nom = s.nominal
    share = f" ({100 * stream / nom:.0f}% of nominal {nom:.0f})" if nom else ""
    log(f"STREAM triad: {stream:.1f} GB/s{share}")
    read_bw = s.read_bw = measure_stream_read(z.stream_floats,
                                              device=s.device)
    s.extra["stream_read_GBps"] = round(read_bw, 1)
    dma = s.dma = measure_dma_read_gbps(z.dma_floats,
                                        tile_rows=z.dma_tile_rows,
                                        device=s.device)
    s.extra["dma_read_GBps"] = round(dma, 1)
    # The denominator is the data sheet's rate unless a measurement is
    # above it: the measured ceilings are lower bounds of what the card
    # reads, and a kernel that beats them is not faster than the pins.
    s.roof, excluded = roofline_denominator(stream, read_bw, dma,
                                            nominal=nom)
    if excluded:
        log("WARNING: a measured ceiling exceeded the pin bandwidth and was "
            "excluded from the denominator")
    log(f"read-only: torch.sum {read_bw:.1f} GB/s, K12 {dma:.1f} GB/s "
        f"(physical-fraction denominator = {s.roof:.1f} [max incl. "
        f"nominal {nom}])")


def section_cg100(s: Suite) -> None:
    """2. Headline: CG at 100^3 on DIA, standard and cs."""
    n = s.sizes.n100
    A, b, xexact, setup = build_stencil_dia(n, s.device, s.policy)
    s.dia100 = (A, b, xexact)
    s.extra["setup100_seconds"] = round(setup["cold"], 3)
    s.extra["setup100_build_seconds"] = round(setup["build"], 3)
    s.extra["setup100_compile_seconds"] = round(setup["compile"], 3)
    t_std = timed_cg(A, b, xexact, n)
    if t_std is None:
        s.fail(f"cg {n}^3 dia standard: every attempt INVALID")
    s.take100(t_std, "standard")
    t_cs = timed_cg(A, b, xexact, n, attempts=2, variant="cs")
    if t_cs is None:
        s.fail(f"cg {n}^3 dia cs: every attempt INVALID")
    else:
        s.extra["cg100_cs_seconds"] = round(t_cs, 4)
        s.take100(t_cs, "cs")


def section_spmv100(s: Suite) -> None:
    """3. DIA SpMV at 100^3, effective and physical."""
    A = s.dia100[0]
    n = s.sizes.n100
    dt, sp = spmv_chain_stats(A)
    model_bytes = A.nnz * (s.policy.value_bytes + s.policy.index_bytes)
    gbps = model_bytes / dt / 1e9
    pgbps = phys_gbps(A, dt)
    s.extra["spmv_GBps"] = round(gbps, 1)
    s.extra["spmv100_phys_GBps"] = round(pgbps, 1)
    s.extra["spmv100_spread"] = round(sp, 3)
    log(f"spmv {n}^3 dia: {dt * 1e3:.4f} ms (spread {sp:.1%}), {gbps:.1f} "
        f"GB/s effective (reference byte model), {pgbps:.1f} GB/s physical")


def section_dia200(s: Suite) -> None:
    """4. hpcg.par's 200^3 on DIA: SpMV and CG."""
    n = s.sizes.n200
    A2, b2, xexact2, setup2 = build_stencil_dia(n, s.device, s.policy)
    s.extra["setup200_seconds"] = round(setup2["cold"], 3)
    s.extra["setup200_build_seconds"] = round(setup2["build"], 3)
    s.extra["setup200_compile_seconds"] = round(setup2["compile"], 3)
    with s.part(f"spmv {n}^3"):
        dt2, sp2 = spmv_chain_stats(A2, reps=20, trials=3)
        model = A2.nnz * (s.policy.value_bytes + s.policy.index_bytes)
        gbps2 = model / dt2 / 1e9
        pgbps2 = phys_gbps(A2, dt2)
        s.extra["spmv200_GBps"] = round(gbps2, 1)
        s.extra["spmv200_phys_GBps"] = round(pgbps2, 1)
        s.extra["spmv200_spread"] = round(sp2, 3)
        log(f"spmv {n}^3 dia: {dt2 * 1e3:.4f} ms (spread {sp2:.1%}), "
            f"{gbps2:.1f} GB/s effective, {pgbps2:.1f} GB/s physical")
        if s.roof:
            best_eff = max(gbps2, s.extra.get("spmv_GBps", 0.0))
            s.extra["spmv_frac_of_stream"] = round(pgbps2 / s.roof, 3)
            s.extra["spmv_effective_frac_of_stream"] = round(
                best_eff / s.stream, 3)
            log(f"best spmv physical/read-roof = {pgbps2 / s.roof:.2f} "
                f"(target >= {TARGET_FRACTION}); effective/triad = "
                f"{best_eff / s.stream:.2f}")
    best200 = timed_cg(A2, b2, xexact2, n, attempts=2)
    if best200 is None:
        s.fail(f"cg {n}^3 dia: every attempt INVALID")
    else:
        s.extra["cg200_seconds"] = round(best200, 4)


def section_bslab200(s: Suite) -> None:
    """5. bslab at 200^3, bf16-compressed (SpMV and CG) and f32 (SpMV)."""
    from sparsebench_tpu_torch.formats.bslab import BslabMatrix
    from sparsebench_tpu_torch.solvers.cg import init_vectors

    n = s.sizes.n200
    (Ab, counts_b), setup = _setup_times(
        lambda: BslabMatrix.from_stencil(n, n, n, device=s.device,
                                         policy=s.policy), s.device)
    s.extra["setup200_bslab_seconds"] = round(setup["cold"], 3)
    s.extra["setup200_bslab_build_seconds"] = round(setup["build"], 3)
    s.extra["setup200_bslab_compile_seconds"] = round(setup["compile"], 3)
    log(f"{n}^3 bslab device build: cold {setup['cold']:.3f}s, warm "
        f"{setup['build']:.3f}s, impl={Ab.impl} sub={Ab.sub} "
        f"s_aff={Ab.s_aff} W={Ab.w_blocks} pad={Ab.padding_ratio:.2f}")
    dtb, spb = spmv_chain_stats(Ab, reps=20, trials=3)
    gbps_b = Ab.nnz * (s.policy.value_bytes + s.policy.index_bytes) / dtb / 1e9
    pgbps_b = phys_gbps(Ab, dtb)
    s.extra["spmv200_bslab_GBps"] = round(gbps_b, 1)
    s.extra["spmv200_bslab_phys_GBps"] = round(pgbps_b, 1)
    s.extra["spmv200_bslab_spread"] = round(spb, 3)
    log(f"spmv {n}^3 bslab: {dtb * 1e3:.4f} ms (spread {spb:.1%}), "
        f"{gbps_b:.1f} GB/s effective, {pgbps_b:.1f} GB/s physical")
    if s.roof:
        s.extra["spmv_general_phys_frac_of_stream"] = round(
            pgbps_b / s.roof, 3)
    _x0, bb, xexact_b = init_vectors(row_lengths=counts_b, dtype=np.float32)
    best_b = timed_cg(Ab, bb, xexact_b, n, attempts=2)
    if best_b is None:
        s.fail(f"cg {n}^3 bslab: every attempt INVALID")
    else:
        s.extra["cg200_bslab_seconds"] = round(best_b, 4)
        if best_b < s.extra.get("cg200_seconds", float("inf")):
            s.extra["cg200_seconds"] = round(best_b, 4)
    del Ab
    with s.part(f"bslab f32 {n}^3"):
        Af, _ = BslabMatrix.from_stencil(n, n, n, device=s.device,
                                         policy=s.policy, compress=False)
        dtf, spf = spmv_chain_stats(Af, reps=15, trials=3)
        pgf = phys_gbps(Af, dtf)
        s.extra["spmv200_bslab_f32_phys_GBps"] = round(pgf, 1)
        s.extra["spmv200_bslab_f32_spread"] = round(spf, 3)
        if s.roof:
            s.extra["spmv_general_f32_phys_frac_of_stream"] = round(
                pgf / s.roof, 3)
        log(f"spmv {n}^3 bslab f32: {dtf * 1e3:.4f} ms (spread {spf:.1%}), "
            f"{pgf:.1f} GB/s physical ({pgf / (s.roof or 1):.2f} of "
            f"read-roof)")


def section_bslab100(s: Suite) -> None:
    """6. bslab cs CG at 100^3."""
    from sparsebench_tpu_torch.formats.bslab import BslabMatrix
    from sparsebench_tpu_torch.solvers.cg import init_vectors

    n = s.sizes.n100
    (A1, counts1), setup = _setup_times(
        lambda: BslabMatrix.from_stencil(n, n, n, device=s.device,
                                         policy=s.policy), s.device)
    s.extra["setup100_bslab_seconds"] = round(setup["cold"], 3)
    s.extra["setup100_bslab_build_seconds"] = round(setup["build"], 3)
    s.extra["setup100_bslab_compile_seconds"] = round(setup["compile"], 3)
    _x0, b1, xexact1 = init_vectors(row_lengths=counts1, dtype=np.float32)
    t = timed_cg(A1, b1, xexact1, n, attempts=2, variant="cs")
    if t is None:
        s.fail(f"cg {n}^3 bslab cs: every attempt INVALID")
    else:
        s.extra["cg100_bslab_seconds"] = round(t, 4)
        s.take100(t, "bslab-cs")


def section_sell100(s: Suite) -> None:
    """6c. SELL against bslab at 100^3. The JAX bench measures SELL through
    its one-shard distributed build; the port has no distributed layer yet
    (ROADMAP.md Queue 1 item 11), so this is ``from_csr("sell", ...)``,
    whose product on the card is the same bslab delegate, against a bslab
    built from the same CSR."""
    from sparsebench_tpu_torch.formats import from_csr
    from sparsebench_tpu_torch.host import generate_stencil

    n = s.sizes.n100
    csr = generate_stencil(n, n, n)
    A_s = from_csr("sell", csr, s.policy, device=s.device, bridge=True)
    if A_s.fast is None or A_s.permuted_output:
        raise RuntimeError("sell was not bridged to its bslab delegate")
    dts, sps = spmv_chain_stats(A_s, reps=20, trials=3)
    pgs = phys_gbps(A_s, dts)  # the delegate's arrays only
    s.extra["spmv100_sell_phys_GBps"] = round(pgs, 1)
    s.extra["spmv100_sell_spread"] = round(sps, 3)
    log(f"spmv {n}^3 sell (from_csr, bslab delegate; no distributed layer "
        f"in the port yet): {dts * 1e3:.4f} ms (spread {sps:.1%}), "
        f"{pgs:.1f} GB/s physical")
    Ab = from_csr("bslab", csr, s.policy, device=s.device)
    dtb, _ = spmv_chain_stats(Ab, reps=20, trials=3)
    ratio = dts / dtb
    s.extra["sell_vs_bslab_ratio"] = round(ratio, 3)
    log(f"sell/bslab time ratio = {ratio:.3f} (target <= 1.2; bslab "
        f"same-CSR {dtb * 1e3:.4f} ms)")


def section_stencil(s: Suite) -> None:
    """6b. The matrix-free stencil operator at 100^3 and 200^3: the apply,
    and CG in the variants standard, cs and fused, and vmem at 100^3 (its
    200^3 run is ``section_vmem200``)."""
    from sparsebench_tpu_torch.formats.stencil import StencilOperator
    from sparsebench_tpu_torch.solvers.cg import init_vectors

    for key, n in (("100", s.sizes.n100), ("200", s.sizes.n200)):
        As, cs = StencilOperator.from_stencil(n, n, n, device=s.device)
        _x0, bs, xes = init_vectors(row_lengths=cs, dtype=np.float32)
        dts = spmv_chain_time(As, reps=200 if key == "100" else 20, trials=3)
        s.extra[f"stencilfree{key}_spmv_ms"] = round(dts * 1e3, 5)
        log(f"matrix-free stencil {n}^3 apply ({As.impl}): "
            f"{dts * 1e3:.4f} ms ({(As.nr + As.nc) * 4 / dts / 1e9:.0f} "
            f"GB/s vectors-only)")
        variants = ["standard", "cs", "fused"] + (["vmem"] if key == "100"
                                                  else [])
        best, best_var = None, None
        for var in variants:
            t = timed_cg(As, bs, xes, n, attempts=2, variant=var)
            if t is None:
                s.fail(f"cg {n}^3 stencil {var}: every attempt INVALID")
                continue
            if best is None or t < best:
                best, best_var = t, var
            if var in ("fused", "vmem"):
                s.extra[f"cg{key}_{var}_seconds"] = round(t, 4)
        if best is None:
            continue
        s.extra[f"cg{key}_stencilfree_seconds"] = round(best, 4)
        if key == "100":
            s.take100(best, f"stencil-free/{best_var}")
        elif best < s.extra.get("cg200_seconds", float("inf")):
            s.extra["cg200_seconds"] = round(best, 4)
            s.extra["cg200_variant"] = f"stencil-free/{best_var}"


def section_vmem200(s: Suite) -> None:
    """6b1. The whole-solve vmem CG (K5) on hpcg.par's 200^3 workload, where
    its vectors stream from device memory: valid only with k = 150 (or a
    residual of exactly 0) and max|x - 1| < 1e-5."""
    from sparsebench_tpu_torch.formats.stencil import StencilOperator
    from sparsebench_tpu_torch.solvers.cg import init_vectors

    n = s.sizes.n200
    A, counts = StencilOperator.from_stencil(n, n, n, device=s.device)
    _x0, b, xexact = init_vectors(row_lengths=counts, dtype=np.float32)
    t = timed_cg(A, b, xexact, n, attempts=2, variant="vmem", diff_tol=1e-5,
                 full_k=True)
    if t is None:
        s.fail(f"cg {n}^3 stencil vmem: every attempt INVALID")
        return
    s.extra["cg200_vmem_seconds"] = round(t, 4)
    if t < s.extra.get("cg200_seconds", float("inf")):
        s.extra["cg200_seconds"] = round(t, 4)
        s.extra["cg200_variant"] = "stencil-free/vmem"


def section_mixed(s: Suite) -> None:
    """6b2. Mixed precision at 200^3 on the stencil: bf16 CG (150
    iterations) and refinement (f32 outer sweeps, bf16 inner CG)."""
    from sparsebench_tpu_torch.formats.stencil import StencilOperator
    from sparsebench_tpu_torch.solvers.cg import check_residual, init_vectors
    from sparsebench_tpu_torch.solvers.refine import solve_cg_refine

    n = s.sizes.n200
    Am, cm = StencilOperator.from_stencil(n, n, n, device=s.device)
    _x0, b32, xem = init_vectors(row_lengths=cm, dtype=np.float32)
    b16 = torch.from_numpy(b32).to(s.device, torch.bfloat16)
    t16 = timed_cg(Am, b16, xem, n, attempts=2, diff_tol=0.1)
    if t16 is None:
        s.fail(f"cg {n}^3 stencil bf16: every attempt INVALID")
    else:
        s.extra["cg200_stencil_bf16_seconds"] = round(t16, 4)
    rres = solve_cg_refine(Am, b32, outer_max=12, inner_iters=150, eps=0.0,
                           verbose=False)
    rdiff = check_residual(rres.x, xem)
    log(f"refine {n}^3 (f32 outer / bf16 inner): {rres.solve_seconds:.4f}s, "
        f"{rres.iterations} inner iters, max|x-1| {rdiff:.1e}")
    if np.isfinite(rdiff) and rdiff < 1e-4:
        s.extra["cg200_refine_seconds"] = round(rres.solve_seconds, 4)
        s.extra["cg200_refine_diff"] = float(f"{rdiff:.2e}")
    else:
        s.fail(f"refine {n}^3 INVALID: max|x-1| {rdiff:.2e}")


def section_7pt(s: Suite) -> None:
    """6c. The 7-point stencil (reference generate7P, src/matrix.c:86) at
    100^3."""
    from sparsebench_tpu_torch.formats.stencil import StencilOperator
    from sparsebench_tpu_torch.solvers.cg import init_vectors

    n = s.sizes.n100
    A7, c7 = StencilOperator.from_stencil(n, n, n, use_7pt=True,
                                          device=s.device)
    _x0, b7, xe7 = init_vectors(row_lengths=c7, dtype=np.float32)
    t7 = timed_cg(A7, b7, xe7, n, attempts=2)
    if t7 is None:
        s.fail(f"cg {n}^3 7-pt: every attempt INVALID")
    else:
        s.extra["cg100_7pt_seconds"] = round(t7, 4)


def section_rgl(s: Suite) -> None:
    """7. RGL, the irregular random-graph Laplacian (2M rows at the
    published size), built on the device: build, SpMV, and CG on a rough
    exact solution (b = 1 is an eigenvector: CG would stop at once)."""
    from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab
    from sparsebench_tpu_torch.solvers.cg import check_residual, solve_cg

    n_rgl = s.sizes.rgl_n
    (Ar, nnz_r), setup = _setup_times(
        lambda: rgl_bslab(n_rgl, band=512, deg=16.0, seed=1, device=s.device,
                          policy=s.policy), s.device)
    s.extra["rgl_setup_seconds"] = round(setup["cold"], 3)
    s.extra["rgl_build_seconds"] = round(setup["build"], 3)
    s.extra["rgl_compile_seconds"] = round(setup["compile"], 3)
    s.extra["rgl_nnz"] = nnz_r
    log(f"RGL n={n_rgl} nnz={nnz_r}: device build cold {setup['cold']:.3f}s,"
        f" warm {setup['build']:.3f}s, impl={Ar.impl} s_gen={Ar.s_gen} "
        f"pad={Ar.padding_ratio:.2f}")
    yv = Ar.spmv(torch.ones(n_rgl, dtype=torch.float32, device=s.device))
    err1 = float((yv - 1.0).abs().max())
    if not (bool(torch.isfinite(yv).all()) and err1 < 1e-2):
        raise RuntimeError(f"RGL validation: max|A@1 - 1| = {err1:.2e}")
    dtr, spr = spmv_chain_stats(Ar, reps=20, trials=3)
    gr = nnz_r * 8 / dtr / 1e9
    pgr = phys_gbps(Ar, dtr)
    s.extra["rgl_spmv_GBps"] = round(gr, 1)
    s.extra["rgl_spmv_phys_GBps"] = round(pgr, 1)
    s.extra["rgl_spmv_spread"] = round(spr, 3)
    if s.roof:
        s.extra["rgl_phys_frac_of_stream"] = round(pgr / s.roof, 3)
    if s.stream:
        s.extra["rgl_eff_frac_of_stream"] = round(gr / s.stream, 3)
    log(f"RGL spmv: {dtr * 1e3:.4f} ms (spread {spr:.1%}), {gr:.1f} GB/s "
        f"effective, {pgr:.1f} GB/s physical ({pgr / (s.roof or 1):.2f} of "
        f"read-roof)")
    xe = 0.5 + (torch.arange(n_rgl, dtype=torch.float32, device=s.device)
                % 97) / 97.0
    br = Ar.spmv(xe)
    res = solve_cg(Ar, br, itermax=150, eps=0.0, verbose=False)
    err = check_residual(res.x, xe.cpu().numpy())
    ok = bool(np.isfinite(res.residual_history).all()) and err < 1e-2
    log(f"RGL cg: {res.solve_seconds:.4f}s ({res.iterations} iters, "
        f"max|x-xe| {err:.2e}, {'ok' if ok else 'INVALID'})")
    if not ok:
        raise RuntimeError(f"RGL cg INVALID: max|x-xe| {err:.2e}")
    s.extra["rgl_cg150_seconds"] = round(res.solve_seconds, 4)


def section_solvers(s: Suite) -> None:
    """8. The solver family at 100^3 (GMRES(30), BiCGStab, MINRES,
    Chebyshev; each warms up inside), GMRES with Jacobi and with
    Chebyshev(4) preconditioning to 1e-8 of ||b||, and GMRES on the klein
    band matrix (the .mtx ingest path)."""
    from sparsebench_tpu_torch.solvers.bicgstab import solve_bicgstab
    from sparsebench_tpu_torch.solvers.chebyshev import solve_chebyshev
    from sparsebench_tpu_torch.solvers.gmres import solve_gmres
    from sparsebench_tpu_torch.solvers.minres import solve_minres
    from sparsebench_tpu_torch.solvers.precond import cheb_precond_for

    A, b, _xexact = s.dia100
    n = s.sizes.n100
    for name, fn, kw in (("gmres", solve_gmres, {"restart": 30}),
                         ("bicgstab", solve_bicgstab, {}),
                         ("minres", solve_minres, {}),
                         ("cheb", solve_chebyshev, {})):
        with s.part(f"{name} {n}^3"):
            res = fn(A, b, itermax=150, eps=0.0, verbose=False, **kw)
            err = float(np.abs(np.asarray(res.x, np.float64) - 1.0).max())
            s.extra[f"{name}100_seconds"] = round(res.solve_seconds, 4)
            s.extra[f"{name}100_iters"] = int(res.iterations)
            s.extra[f"{name}100_final_normr"] = float(
                f"{res.final_normr:.3e}")
            s.extra[f"{name}100_diff"] = float(f"{err:.2e}")
            log(f"  {name} {n}^3 [f32]: {res.solve_seconds:.4f}s "
                f"({res.iterations} iters, final residual "
                f"{res.final_normr:.2e}, max|x-1| {err:.2e})")
    # relative bar: ||r|| <= 1e-8 ||b|| (the solvers' eps is absolute)
    eps8 = 1e-8 * float(np.linalg.norm(np.asarray(b, np.float64)))
    for key, label, kw in (
            ("jacobi", "gmres+jacobi",
             lambda: {"inv_diag": np.full(A.nr, 1.0 / 27.0, np.float32)}),
            ("cheb", "gmres+cheb4", lambda: {"precond": cheb_precond_for(
                A, A.nr, torch.float32, degree=4)})):
        with s.part(f"{label} {n}^3"):
            r = solve_gmres(A, b, itermax=450, eps=eps8, restart=30,
                            verbose=False, **kw())
            conv = r.final_normr <= eps8
            s.extra[f"gmres100_{key}_iters_to_1e8"] = (
                int(r.iterations) if conv else -1)
            s.extra[f"gmres100_{key}_final_normr"] = float(
                f"{r.final_normr:.3e}")
            s.extra[f"gmres100_{key}_seconds"] = round(r.solve_seconds, 4)
            state = (f"converged at iter {int(r.iterations)}" if conv
                     else f"NOT converged in {int(r.iterations)}")
            log(f"  {label} {n}^3 [f32, bar 1e-8 rel = {eps8:.2e}]: "
                f"{r.solve_seconds:.4f}s, {state}, final residual "
                f"{r.final_normr:.2e}")
    with s.part("gmres klein"):
        from sparsebench_tpu_torch.formats import from_csr
        from sparsebench_tpu_torch.host import read_mm

        csr_k = read_mm(str(REPO / "data" / "matrix_band_klein.mtx"))
        Ak = from_csr("bslab", csr_k, s.policy, device=s.device)
        xk = torch.linspace(0.5, 1.5, csr_k.nr, dtype=torch.float64).to(
            s.device, torch.float32)
        bk = Ak.spmv(xk)
        rk = solve_gmres(Ak, bk, itermax=150, eps=0.0, restart=30,
                         verbose=False)
        errk = float(np.abs(np.asarray(rk.x, np.float64)
                            - xk.cpu().double().numpy()).max())
        s.extra["gmres_klein_seconds"] = round(rk.solve_seconds, 4)
        s.extra["gmres_klein_final_normr"] = float(f"{rk.final_normr:.3e}")
        log(f"  gmres klein [f32]: {rk.solve_seconds:.4f}s ({rk.iterations} "
            f"iters, final residual {rk.final_normr:.2e}, max|x-xe| "
            f"{errk:.2e})")


def section_cg_multi(s: Suite) -> None:
    """Blocked CG, k = 8 right-hand sides (b scaled by 1 .. 2) at 100^3,
    beside one single-RHS solve in the same run."""
    from sparsebench_tpu_torch.solvers.cg import solve_cg
    from sparsebench_tpu_torch.solvers.cg_multi import solve_cg_multi

    A, b, _xexact = s.dia100
    n = s.sizes.n100
    k = 8
    scales = np.linspace(1.0, 2.0, k)
    B = (np.asarray(b, np.float64)[:, None] * scales[None, :]).astype(
        np.float32)
    resm = solve_cg_multi(A, B, itermax=150, eps=0.0, verbose=False)
    errm = float(np.abs(np.asarray(resm.x, np.float64) / scales[None, :]
                        - 1.0).max())
    if not errm < 1e-4:
        raise RuntimeError(f"cg-multi {n}^3 INVALID: max|x/s-1| {errm:.2e}")
    single = solve_cg(A, b, itermax=150, eps=0.0, verbose=False)
    s.extra["cg100_nrhs8_seconds"] = round(resm.solve_seconds, 4)
    s.extra["cg100_nrhs8_per_rhs_seconds"] = round(resm.solve_seconds / k, 5)
    s.extra["cg100_nrhs8_diff"] = float(f"{errm:.2e}")
    s.extra["cg100_nrhs8_speedup"] = round(
        k * single.solve_seconds / resm.solve_seconds, 3)
    log(f"  cg-multi {n}^3 [f32, k=8, tol 1e-4]: {resm.solve_seconds:.4f}s "
        f"total = {resm.solve_seconds / k * 1e3:.2f} ms/RHS; one single-RHS "
        f"solve {single.solve_seconds:.4f}s; speedup "
        f"{s.extra['cg100_nrhs8_speedup']} (max|x/s-1| {errm:.2e}, ok)")


SECTIONS = (
    ("kernel build", section_build),
    ("ceilings", section_ceilings),
    ("cg 100^3", section_cg100),
    ("spmv 100^3", section_spmv100),
    ("dia 200^3", section_dia200),
    ("bslab 200^3", section_bslab200),
    ("bslab 100^3", section_bslab100),
    ("sell 100^3", section_sell100),
    ("matrix-free stencil", section_stencil),
    ("vmem 200^3", section_vmem200),
    ("stencil mixed precision", section_mixed),
    ("7-pt stencil", section_7pt),
    ("RGL", section_rgl),
    ("solver family", section_solvers),
    ("cg multi", section_cg_multi),
)


def device_label(device: torch.device) -> str:
    """The card's name and power limit from nvidia-smi (its torch name
    where nvidia-smi is missing), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return nvidia_smi() or torch.cuda.get_device_name(device)


def _start(device: torch.device) -> Optional[float]:
    """Log the host's fingerprint; return the card's data-sheet HBM rate
    (None on the CPU or for an unknown card)."""
    from sparsebench_tpu_torch.ops import _build

    try:
        nvcc = _build.find_nvcc()
    except FileNotFoundError:
        nvcc = "none"
    log(f"device {device_label(device)} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | nvcc {nvcc}")
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    nominal = nominal_hbm_gbps(name)
    if nominal is None:
        log(f"unknown card {name!r}: no data-sheet HBM rate; fractions use "
            "the measured ceilings only")
    log("vs_baseline: null (the C reference has not been timed on this "
        "card's host)")
    return nominal


def run_suite(device: torch.device, sizes: Optional[Sizes] = None) -> int:
    """Every section in order; the JSON line; 1 if any section failed."""
    s = Suite(device=device, sizes=sizes or Sizes())
    s.nominal = _start(device)
    for name, fn in SECTIONS:
        with s.part(name):
            fn(s)
    if s.roof:
        phys = [v for k, v in s.extra.items() if k.endswith("_phys_GBps")]
        if phys:
            s.extra["spmv_frac_of_stream"] = round(max(phys) / s.roof, 3)
    if s.best100 is None:
        s.fail("no valid 100^3 CG time")
    if s.failures:
        log(f"{len(s.failures)} failure(s); exit 1")
    return emit({"metric": "cg_stencil100cubed_150iter_solve_seconds",
                 "value": round(s.best100 or 0.0, 4), "unit": "s",
                 "vs_baseline": None, "device": device_label(device),
                 "extra": s.extra}, rc=1 if s.failures else 0)


def bench_cg(n: int, device: torch.device) -> int:
    _start(device)
    policy = DTypePolicy.from_names("f32", "i32")
    A, b, xexact, _setup = build_stencil_dia(n, device, policy)
    best = timed_cg(A, b, xexact, n)
    return emit({"metric": f"cg_stencil{n}cubed_150iter_solve_seconds",
                 "value": round(best or 0.0, 4), "unit": "s",
                 "vs_baseline": None, "device": device_label(device)},
                rc=0 if best is not None else 1)


def _build_generated(fmt: str, n: int, policy: DTypePolicy, device):
    """The n^3 stencil in ``fmt``: the on-device builds for dia, bslab,
    bsell and stencil (the CLI builds bsell through the host CSR, which at
    200^3 would take minutes), the host CSR for the others."""
    from sparsebench_tpu_torch.formats import from_csr, get_format
    from sparsebench_tpu_torch.host import generate_stencil

    if fmt in ("dia", "bslab", "bsell", "stencil"):
        return get_format(fmt).from_stencil(n, n, n, device=device,
                                            policy=policy)[0]
    return from_csr(fmt, generate_stencil(n, n, n), policy, device=device)


def bench_spmv(n: int, fmts, device: torch.device) -> int:
    nominal = _start(device)
    policy = DTypePolicy.from_names("f32", "i32")
    results, failed = {}, False
    for fmt in fmts:
        try:
            t0 = time.perf_counter()
            A = _build_generated(fmt, n, policy, device)
            synchronize(device)
            build_s = time.perf_counter() - t0
            dt = spmv_chain_time(A)
            gbps = A.nnz * (policy.value_bytes + policy.index_bytes) / dt / 1e9
            results[fmt] = gbps
            log(f"{fmt}: build {build_s:.3f}s, {dt * 1e3:.4f} ms/spmv, "
                f"{gbps:.1f} GB/s effective, {phys_gbps(A, dt):.1f} GB/s "
                f"physical")
        except Exception as e:  # noqa: BLE001 — logged, rc 1
            log(f"{fmt}: failed: {e!r}")
            failed = True
    if not results:
        return emit({"metric": "spmv_effective_bandwidth", "value": 0.0,
                     "unit": "GB/s", "vs_baseline": None,
                     "device": device_label(device)}, rc=1)
    best_fmt = max(results, key=results.get)
    value = results[best_fmt]
    target = nominal * TARGET_FRACTION if nominal else None
    return emit({
        "metric": f"spmv_effective_bandwidth_{n}cubed_{best_fmt}",
        "value": round(value, 2), "unit": "GB/s",
        "vs_baseline": round(value / target, 4) if target else None,
        "device": device_label(device),
    }, rc=1 if failed else 0)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparsebench_tpu_torch.bench",
        description="The port's benchmark suite: one JSON line on stdout.")
    ap.add_argument("mode", nargs="*", metavar="cg [n] | spmv [n] [fmts]",
                    help="cg: CG on the n^3 stencil (DIA); spmv: SpMV of "
                    "each format; none: the full suite")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path, for tests)")
    ap.add_argument("--small", action="store_true",
                    help="the full suite at test sizes")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        log(f"sparsebench_tpu_torch.bench: {e}")
        return 2
    mode = args.mode
    if mode and mode[0] == "spmv":
        n = int(mode[1]) if len(mode) > 1 else 100
        fmts = mode[2].split(",") if len(mode) > 2 else ["dia", "bslab"]
        return bench_spmv(n, fmts, device)
    if mode and mode[0] == "cg":
        return bench_cg(int(mode[1]) if len(mode) > 1 else 100, device)
    if mode:
        return bench_cg(int(mode[0]), device)
    return run_suite(device, Sizes.small() if args.small else None)


if __name__ == "__main__":
    sys.exit(main())
