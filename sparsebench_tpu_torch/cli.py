"""Command-line entry point (reference src/main.c; counterpart of
sparsebench_tpu/cli.py).

The reference flags ``-h -f -m -t -x -y -z -i -e`` plus ``--fmt``,
``--sub``, ``-C/--chunk-height``, ``--sigma``, ``--band``, ``--deg``,
``--seed``, ``--rcm``, ``--dtype``, ``--index-dtype``, ``--impl``,
``--device``, ``--trace`` and the solver family's ``--cg-variant``,
``--sstep``, ``--precond``, ``--precond-degree``, ``--nrhs``, ``--refine``,
``--refine-sweeps``, ``--restart``, ``--orth``, ``--checkpoint``,
``--checkpoint-every``, ``--profile`` and ``--banner``. Flow
(src/main.c:83-230): banner -> matrix -> profiler factors -> the bench
(``-t cg`` in any CG variant, blocked over ``--nrhs`` right-hand sides,
refined, checkpointed or profiled by region; ``spmv``; ``gmres``,
``cheb``, ``bicgstab`` or ``minres``) -> report. Warnings for flags that do
not reach the chosen bench, and refusals of combinations, keep the JAX
CLI's wording. The matrix is one of:

* ``-m generateRGL``: the irregular random-graph Laplacian built on the
  device straight into bslab (formats/rgl_build.py), n = x*y*z;
* the generated stencil built on the device into DIA (``auto``), bslab,
  CRS (``crs``, ``ccrs``) or the matrix-free ``stencil`` operator; ``--fmt
  sell`` runs the bslab build (the JAX CLI's bridge), and bsell and ell go
  through the host CSR;
* a .mtx/.bmx file through the host CSR (``--rcm`` reorders it first) into
  the format asked for; ``auto`` takes DIA and falls back to bslab where
  the matrix has too many diagonals.

The default device is ``cuda``; without CUDA the run exits with an error
instead of running on the CPU (``--device cpu`` runs the plain PyTorch
path). A .par file's ``shards``, which is not ported, exits and names the
ROADMAP.md item that ports it; the JAX CLI's other flags (``--shards``,
``--exchange``, ``--overlap``, ``-c``) are absent, so argparse rejects
them.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from sparsebench_tpu_torch.config import (
    DTypePolicy,
    Parameter,
    print_parameter,
    read_parameter,
    resolve_device,
)
from sparsebench_tpu_torch.solvers.cg import CG_VARIANTS
from sparsebench_tpu_torch.version import __version__

BANNER = "SparseBench — PyTorch/CUDA port of sparsebench_tpu"

BENCHES = ["cg", "spmv", "gmres", "cheb", "bicgstab", "minres"]
FORMATS = ["auto", "crs", "ccrs", "sell", "ell", "dia", "bsell", "bslab",
           "stencil"]


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="sparsebench_tpu_torch",
        description="Sparse solver benchmark (CG / SpMV over DIA or the "
        "matrix-free stencil) on PyTorch and CUDA — the port of "
        "sparsebench_tpu.",
        allow_abbrev=False,
    )
    # reference flags (src/main.c:24-40)
    ap.add_argument("-f", metavar="FILE", dest="par_file",
                    help="Load options from a parameter file")
    ap.add_argument("-m", metavar="FILE", dest="mm_file",
                    help="Load a matrix market (.mtx) or binary (.bmx) file")
    ap.add_argument("-t", dest="bench", default=None, choices=BENCHES,
                    help="Benchmark type. Default cg.")
    ap.add_argument("-x", type=int, default=None, help="Generated size in x")
    ap.add_argument("-y", type=int, default=None, help="Generated size in y")
    ap.add_argument("-z", type=int, default=None, help="Generated size in z")
    ap.add_argument("-i", type=int, default=None, dest="itermax",
                    help="Number of solver iterations. Default 150.")
    ap.add_argument("-e", type=float, default=None, dest="eps",
                    help="Convergence criteria epsilon. Default 0.0.")
    # runtime options (compile-time in the reference, config.mk:1-8)
    ap.add_argument("--fmt", default=None, choices=FORMATS,
                    help="Matrix format. Default auto: dia, and bslab for a "
                    "matrix file DIA refuses (generateRGL is always bslab). "
                    "stencil is matrix-free and takes generated problems "
                    "only; bsell goes through the host CSR.")
    ap.add_argument("--sub", type=int, default=None,
                    help="bslab slice height in 128-row lane groups "
                    "(default 64, shrunk for small matrices)")
    ap.add_argument("--dtype", default=None, choices=["f64", "f32", "bf16"],
                    help="Value dtype (reference FLOAT_TYPE). Default f32.")
    ap.add_argument("--index-dtype", default=None, choices=["i32", "i64"],
                    help="Index dtype of the reference byte model. Default i32.")
    ap.add_argument("-C", "--chunk-height", type=int, default=None,
                    help="SELL-C-sigma chunk height C (0 = auto)")
    ap.add_argument("--impl", default="auto",
                    help="Kernel implementation: auto, torch (the plain "
                    "PyTorch versions), kernel (the CUDA kernels), "
                    "kernel_win (bslab's and bsell's windowed kernels, x "
                    "staged in shared memory where the window fits) or "
                    "kernel_win2 (bsell's chunk-resident windowed kernel). "
                    "Default auto: kernel on CUDA, torch on the CPU.")
    ap.add_argument("--sigma", type=int, default=None,
                    help="SELL-C-sigma sorting scope (0 = full sort)")
    ap.add_argument("--device", default="cuda",
                    help="torch device, cuda (default) or cpu. Without CUDA "
                    "the default exits with an error.")
    ap.add_argument("--profile", action="store_true",
                    help="Per-region timing report (reference profiler table)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="Write a Chrome trace to DIR/trace.json: the "
                         "card's CUDA activity (device operations and the "
                         "runtime calls that issued them) and the program's "
                         "spans; no host operations")
    ap.add_argument("--checkpoint", metavar="PATH", default=None,
                    help="Checkpoint solver state to PATH and resume from it")
    ap.add_argument("--checkpoint-every", type=int, default=50,
                    help="Iterations between checkpoints (default 50)")
    ap.add_argument("--precond", default="none",
                    choices=["none", "jacobi", "cheb", "cheb-jacobi"],
                    help="Preconditioning (the reference has none). jacobi: "
                    "PCG for -t cg, right-preconditioned GMRES/BiCGStab, "
                    "M^-1 A Chebyshev and MINRES; cheb: Chebyshev polynomial "
                    "PCG (-t cg variants standard/cs/pipe, gmres, bicgstab), "
                    "degree SpMVs an apply and no extra reduction; "
                    "cheb-jacobi: the polynomial on D^-1 A")
    ap.add_argument("--precond-degree", type=int, default=3,
                    help="Chebyshev preconditioner degree (default 3; only "
                    "with --precond cheb/cheb-jacobi)")
    ap.add_argument("--cg-variant", default="standard", dest="cg_variant",
                    choices=CG_VARIANTS,
                    help="CG formulation: standard, cs (single reduction; "
                    "SB_FUSED_CS=1 fuses it on --fmt stencil), sstep "
                    "(s-step CG, one gram reduction per --sstep "
                    "iterations), pipe (pipelined CG), fused and vmem "
                    "(--fmt stencil only; vmem: the whole solve in one "
                    "launch)")
    ap.add_argument("--sstep", type=int, default=4,
                    help="Basis size s for --cg-variant sstep (default 4)")
    ap.add_argument("--nrhs", type=int, default=1,
                    help="Solve N right-hand sides at once with blocked CG "
                    "(-t cg, a stored format): one read of the matrix an "
                    "iteration serves all N (DIA: the multi-RHS kernel)")
    ap.add_argument("--refine", action="store_true",
                    help="Mixed-precision iterative refinement for -t cg: "
                    "outer true-residual sweeps at --dtype, inner CG one "
                    "precision down (f64->f32, f32->bf16). -i caps the "
                    "inner iterations a sweep; -e is the outer target, 0 = "
                    "run to the low precision's floor")
    ap.add_argument("--refine-sweeps", type=int, default=12,
                    help="Max outer refinement sweeps (default 12)")
    ap.add_argument("--restart", type=int, default=30,
                    help="GMRES(m) restart length (default 30)")
    ap.add_argument("--orth", default="cgs", choices=["cgs", "cgs2"],
                    help="GMRES orthogonalization: classical Gram-Schmidt "
                    "or reorthogonalized CGS2")
    ap.add_argument("--band", type=int, default=None,
                    help="generateRGL: half-bandwidth of the random graph "
                    "(default 512)")
    ap.add_argument("--deg", type=float, default=None,
                    help="generateRGL: target average degree (default 16)")
    ap.add_argument("--seed", type=int, default=None,
                    help="generateRGL: graph seed (default 1)")
    ap.add_argument("--rcm", action="store_true",
                    help="Reverse Cuthill-McKee row/column reordering of a "
                    "matrix file before the format conversion")
    ap.add_argument("--banner", action="store_true",
                    help="Print the device table (reference affinity map)")
    ap.add_argument("--version", action="version", version=__version__)
    return ap


def apply_args(param: Parameter, args: argparse.Namespace) -> Parameter:
    """CLI overrides .par file overrides defaults (reference main.c)."""
    if args.par_file:
        read_parameter(param, args.par_file)
    if args.mm_file:
        param.filename = args.mm_file
    for key_cli, key_param in [
        ("x", "nx"), ("y", "ny"), ("z", "nz"), ("itermax", "itermax"),
        ("eps", "eps"), ("fmt", "fmt"), ("dtype", "dtype"),
        ("index_dtype", "index_dtype"), ("chunk_height", "chunk_height"),
        ("sigma", "sigma"), ("bench", "bench"), ("band", "band"),
        ("deg", "deg"), ("seed", "seed"),
    ]:
        v = getattr(args, key_cli, None)
        if v is not None:
            setattr(param, key_param, v)
    return param


def _refuse_unported(param: Parameter) -> None:
    """SystemExit naming the ROADMAP.md item of a .par file's shards, which
    is not ported."""
    if param.shards > 1:
        raise SystemExit("shards > 1 is not ported to sparsebench_tpu_torch "
                         "yet (ROADMAP.md Queue 1 item 11)")


def init_matrix(param: Parameter):
    """Reference initMatrix (src/main.c:54-81): the host CSR of the
    generated stencil or of a .mtx or .bmx file."""
    from sparsebench_tpu_torch.host import generate_stencil, read_bmx, read_mm

    fn = param.filename
    if fn in ("generate", "generate7P"):
        return generate_stencil(param.nx, param.ny, param.nz,
                                use_7pt=fn == "generate7P")
    if fn.endswith(".mtx"):
        print("Read MTX matrix")
        return read_mm(fn)
    if fn.endswith(".bmx"):
        print("Read BMX matrix")
        return read_bmx(fn)
    raise SystemExit(f"Unknown matrix file format: {fn}")


def banner_impl(impl: str, device: torch.device, fmt: str) -> str:
    """The --impl choice as the banner shows it: ``auto`` resolves to
    ``kernel`` on CUDA and ``torch`` on the CPU; a kernel on the CPU and a
    name the format does not know raise (bsell and bslab check their own
    names, with the JAX CLI's wording). Each format resolves ``impl`` again
    for itself (bslab has ``kernel_win``, bsell ``kernel_win`` and
    ``kernel_win2``)."""
    from sparsebench_tpu_torch.formats import bsell, bslab, dia

    if fmt == "bsell":
        return bsell.resolve_impl(impl, device)
    if fmt == "bslab":
        return bslab.resolve_impl(impl, device)
    if impl in ("kernel_win", "kernel_win2"):
        dia.resolve_impl("kernel", device)
        return impl
    return dia.resolve_impl(impl, device)


def build_matrix(param: Parameter, args: argparse.Namespace,
                 policy: DTypePolicy, device: torch.device):
    """The device matrix of ``param`` (the JAX CLI's three branches:
    generateRGL, the generated stencil, the host CSR). Returns (A, csr or
    None, row counts or None, total rows, the reference model's nnz) and
    sets ``param.fmt`` to the format built."""
    from sparsebench_tpu_torch.formats import from_csr, get_format
    from sparsebench_tpu_torch.formats.dia import DiaUnsuitableError

    sub = {"sub": args.sub} if args.sub else {}
    generated = param.filename in ("generate", "generate7P")
    use_7pt = param.filename == "generate7P"
    if param.filename == "generateRGL":
        # the irregular matrix, generated and laid out on the device
        if param.fmt not in ("auto", "bslab"):
            raise SystemExit(
                "generateRGL builds on-device in bslab layout; use "
                "--fmt auto|bslab (host formats would need a "
                "disqualifyingly slow host build + upload at scale)"
            )
        from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab

        n = param.nx * param.ny * param.nz
        A, nnz = rgl_bslab(n, band=param.band, deg=param.deg, seed=param.seed,
                           device=device, policy=policy, impl=args.impl,
                           **sub)
        param.fmt = "bslab"
        print(f"RGL: n={n} band={param.band} deg~{param.deg} seed="
              f"{param.seed} nnz={nnz} padding={A.padding_ratio:.2f}")
        return A, None, None, n, nnz
    if generated and param.fmt in ("dia", "stencil", "bslab", "sell", "crs",
                                   "ccrs"):
        # analytic on-device build, no CSR
        pick = param.fmt
        if pick == "sell":
            print("sell: generated problem bridged to the bslab device "
                  "build (SELL layout remains the ingest/golden format)")
            pick = "bslab"
        A, row_counts = get_format(pick).from_stencil(
            param.nx, param.ny, param.nz, device=device, use_7pt=use_7pt,
            policy=policy, impl=args.impl, **(sub if pick == "bslab" else {}))
        param.fmt = pick
        return A, None, row_counts, A.total_nr, 27 * A.total_nr
    csr = init_matrix(param)
    if args.rcm:
        from sparsebench_tpu_torch.host import permute_csr, rcm_permutation

        csr = permute_csr(csr, rcm_permutation(csr))
        print(f"RCM reordering applied ({csr.nr} rows)")
    if param.fmt == "auto":
        try:
            A = from_csr("dia", csr, policy, device=device, impl=args.impl)
            param.fmt = "dia"
        except DiaUnsuitableError:
            A = from_csr("bslab", csr, policy, device=device, impl=args.impl,
                         **sub)
            param.fmt = "bslab"
    else:
        A = from_csr(param.fmt, csr, policy, device=device,
                     **_format_opts(param, args))
    model_nnz = csr.model_total_nnz if csr.model_total_nnz > 0 else \
        csr.total_nnz
    return A, csr, None, csr.total_nr, model_nnz


def _validate(ap: argparse.ArgumentParser, args: argparse.Namespace,
              param: Parameter) -> None:
    """The JAX CLI's flag checks, warnings and refusals, in its wording
    (sparsebench_tpu/cli.py:308-387,625-641): a flag that cannot reach the
    chosen bench warns on stderr, a combination the solvers do not take
    exits before the matrix is built."""
    if args.cg_variant == "sstep" and args.sstep < 1:
        raise SystemExit("--sstep must be >= 1")
    if args.restart < 1:
        raise SystemExit("--restart must be >= 1")
    # defaults come from the parser itself, so the two cannot drift
    for flag, attr, benches in (
        ("--orth", "orth", ("gmres",)),
        ("--restart", "restart", ("gmres",)),
        ("--cg-variant", "cg_variant", ("cg",)),
        ("--checkpoint", "checkpoint", ("cg",)),
        ("--precond", "precond", ("cg", "gmres", "cheb", "bicgstab",
                                  "minres")),
        ("--refine", "refine", ("cg",)),
        ("--nrhs", "nrhs", ("cg",)),
        # only the CG loop and the SpMV bench feed the region timers
        # (reference PROFILE sites: CGSolver.c + main.c:200-216); other
        # benches would print an all-zeros table
        ("--profile", "profile", ("cg", "spmv")),
    ):
        if getattr(args, attr) != ap.get_default(attr) and (
            param.bench not in benches
        ):
            print(f"warning: {flag} has no effect with -t {param.bench}",
                  file=sys.stderr)
    if args.sstep != ap.get_default("sstep") and not (
        args.cg_variant == "sstep" and param.bench == "cg"
    ):
        print("warning: --sstep has no effect without -t cg "
              "--cg-variant sstep", file=sys.stderr)
    if (args.checkpoint_every != ap.get_default("checkpoint_every")
            and not args.checkpoint):
        print("warning: --checkpoint-every has no effect without "
              "--checkpoint", file=sys.stderr)
    if (args.precond_degree != ap.get_default("precond_degree")
            and args.precond not in ("cheb", "cheb-jacobi")):
        print("warning: --precond-degree has no effect without "
              "--precond cheb/cheb-jacobi", file=sys.stderr)
    if (args.refine_sweeps != ap.get_default("refine_sweeps")
            and not args.refine):
        print("warning: --refine-sweeps has no effect without --refine",
              file=sys.stderr)
    if args.refine and (args.precond != "none"
                        or args.cg_variant != "standard"
                        or args.checkpoint or args.profile):
        raise SystemExit(
            "--refine combines with the plain CG path only (no "
            "--precond/--cg-variant/--checkpoint/--profile: the inner "
            "solve IS the acceleration)"
        )
    if args.nrhs < 1:
        raise SystemExit("--nrhs must be >= 1")
    if args.nrhs > 1 and param.bench == "cg" and (
        args.precond != "none" or args.cg_variant != "standard"
        or args.checkpoint or args.profile or args.refine
        or param.fmt == "stencil"
    ):
        raise SystemExit(
            "--nrhs > 1 uses the blocked serial CG path on a stored "
            "format only (no --precond/--cg-variant/--checkpoint/"
            "--profile/--refine/--shards/--fmt stencil)"
        )
    if args.precond in ("cheb", "cheb-jacobi") and param.bench not in (
        "cg", "gmres", "bicgstab"
    ):
        raise SystemExit(
            f"--precond {args.precond} supports -t cg/gmres/bicgstab "
            "(preconditioning the Chebyshev solver with a Chebyshev "
            "polynomial is the same iteration twice: raise --iter instead)"
        )
    # the JAX CLI refuses these inside its CG branch, after the build; here
    # they exit before any device work (a Chebyshev bound estimate included)
    if param.bench == "cg":
        if args.precond in ("cheb", "cheb-jacobi") and (
            args.cg_variant not in ("standard", "cs", "pipe")
        ):
            raise SystemExit(
                f"--precond {args.precond} combines with "
                "--cg-variant standard/cs/pipe only"
            )
        if args.precond != "none" and (args.checkpoint or args.profile):
            raise SystemExit("--precond combines with the plain CG path only")
        if args.cg_variant != "standard" and (args.checkpoint
                                              or args.profile):
            raise SystemExit(
                "--cg-variant combines with the plain CG path only")


def _format_opts(param: Parameter, args: argparse.Namespace) -> dict:
    """``from_csr`` keywords of ``param.fmt`` from the CLI's flags."""
    sub = {"sub": args.sub} if args.sub else {}
    return {"dia": {"impl": args.impl},
            "crs": {"impl": args.impl},
            "ccrs": {"impl": args.impl},
            "bsell": {"impl": args.impl},
            "bslab": {"impl": args.impl, **sub},
            "sell": {"impl": args.impl, "C": param.chunk_height,
                     "sigma": param.sigma}}.get(param.fmt, {})


def build_lo_matrix(param: Parameter, args: argparse.Namespace, A, csr,
                    policy: DTypePolicy, device: torch.device):
    """The low-precision twin of A for --refine: the same build, the same
    layout and row order, one value dtype down (the JAX CLI's
    ``build_lo_matrix``, sparsebench_tpu/cli.py:576-618). The matrix-free
    stencil adopts the vectors' dtype and is its own twin."""
    from sparsebench_tpu_torch.formats import from_csr, get_format
    from sparsebench_tpu_torch.solvers.refine import refine_lo_policy

    lo, lo_name = refine_lo_policy(policy)
    print(f"Refinement: outer {param.dtype} sweeps, inner CG in {lo_name}")
    if param.fmt == "stencil":
        return A
    sub = {"sub": args.sub} if args.sub else {}
    if param.filename == "generateRGL":
        from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab

        return rgl_bslab(param.nx * param.ny * param.nz, band=param.band,
                         deg=param.deg, seed=param.seed, device=device,
                         policy=lo, impl=args.impl, **sub)[0]
    if csr is None:  # the analytic on-device stencil build (dia, bslab, crs)
        bslab = param.fmt == "bslab"
        return get_format(param.fmt).from_stencil(
            param.nx, param.ny, param.nz, device=device,
            use_7pt=param.filename == "generate7P", policy=lo,
            impl=args.impl, **(sub if bslab else {}))[0]
    return from_csr(param.fmt, csr, lo, device=device,
                    **_format_opts(param, args))


def main(argv: Optional[list] = None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    param = apply_args(Parameter(), args)
    _refuse_unported(param)

    from sparsebench_tpu_torch.formats.base import physical_spmv_bytes
    from sparsebench_tpu_torch.profiler import Profiler, trace
    from sparsebench_tpu_torch.solvers.cg import (
        check_residual,
        init_vectors,
        solve_cg,
    )
    from sparsebench_tpu_torch.solvers.profiled import (
        bench_spmv,
        solve_cg_profiled,
    )

    policy = DTypePolicy.from_names(param.dtype, param.index_dtype)
    try:
        device = resolve_device(args.device)
        impl = banner_impl(args.impl, device, param.fmt)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"sparsebench_tpu_torch: {e}") from None
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    if param.fmt == "auto":
        # dia for the generated stencil, bslab for RGL; a matrix file's
        # auto resolves at build time (dia, or bslab where DIA refuses it)
        param.fmt = {"generate": "dia", "generate7P": "dia",
                     "generateRGL": "bslab"}.get(param.filename, "auto")

    print(BANNER)
    print(
        f"sparsebench_tpu_torch {__version__} | format {param.fmt} | "
        f"precision {param.dtype}/{param.index_dtype} | {device_name} | "
        f"spmv {impl}"
    )
    if args.banner:
        from sparsebench_tpu_torch.utils import device_banner

        print(device_banner())
    print(print_parameter(param))  # reference printParameter
    _validate(ap, args, param)

    t0 = time.perf_counter()
    try:
        A, csr, row_counts, total_nr, model_nnz = build_matrix(
            param, args, policy, device)
    except ValueError as e:  # a format or impl that cannot take the matrix
        raise SystemExit(f"sparsebench_tpu_torch: {e}") from None
    rgl = param.filename == "generateRGL"
    generated = param.filename in ("generate", "generate7P")
    print(f"Setup took {time.perf_counter() - t0:.2f}s (format {param.fmt})")
    if param.fmt == "bslab" or getattr(A, "fast", None) is not None:
        B = getattr(A, "fast", None) or A
        print(f"bslab: sub {B.sub}, slices per tile {B.s_aff} affine, "
              f"{B.s_gen} general, {B.s_wide} wide, padding "
              f"{B.padding_ratio:.2f}, spmv {B.impl}")
    elif param.fmt == "bsell":
        print(f"bsell: {A.n_tiles} tiles, {A.s_max} slices per tile, W "
              f"{A.w_blocks}, padding {A.padding_ratio:.2f}, spmv {A.impl}")
    xb = policy.value_bytes
    phys = physical_spmv_bytes(A, xb) - (A.nc + A.nr) * xb
    print(
        f"SpMV streams {phys / max(1, A.nnz):.1f} B/nnz physical "
        f"(stored dtypes x padding) vs the reference model's "
        f"{policy.value_bytes + policy.index_bytes} B/nnz"
    )

    prof = Profiler()
    prof.init_factors(
        total_nr, model_nnz, policy.value_bytes, policy.index_bytes
    )

    def make_vectors():
        """(b on the device, xexact on the host or None)."""
        if rgl:
            # row sums are exactly 1 (host.py): b = A 1 = ones, x == 1
            b = np.ones(A.nr, dtype=policy.host_value)
            xexact = np.ones(A.nr, dtype=policy.host_value)
        else:
            _x0, b, xexact = init_vectors(
                csr, dtype=policy.host_value, generated=generated,
                row_lengths=row_counts,
            )
        return torch.from_numpy(b).to(device=device, dtype=policy.value), \
            xexact

    def make_inv_diag(announce: bool = True):
        """1/diag(A) for --precond jacobi (any solver), original row
        order."""
        if csr is not None:
            d = csr.diagonal()
        elif generated:
            # the generator's diagonal is the constant 27 for the 27- and
            # 7-point stencils (reference src/matrix.c:87-92)
            d = np.full(A.nr, 27.0)
        else:
            # generateRGL builds on the device: its diagonal is not on the
            # host, and a wrong constant would precondition silently
            raise SystemExit(
                f"--precond {args.precond} needs the matrix diagonal on "
                "the host; generateRGL builds on device. Use --shards N "
                "(the host-spec RGL path) for preconditioned RGL solves."
            )
        if announce:
            print("Preconditioner: Jacobi")
        return np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)

    def resolve_precond_pair():
        """(inv_diag, precond) from --precond: the four combinations of
        ``solvers/precond.resolve_apply_m``."""
        from sparsebench_tpu_torch.solvers.precond import cheb_precond_for

        inv_diag = precond = None
        if args.precond in ("jacobi", "cheb-jacobi"):
            inv_diag = make_inv_diag(announce=args.precond == "jacobi")
        if args.precond in ("cheb", "cheb-jacobi"):
            bdt = (torch.float64 if policy.value == torch.float64
                   else torch.float32)
            permute = (A.permute_vector
                       if getattr(A, "permuted_output", False) else None)
            precond = cheb_precond_for(A, A.nr, bdt,
                                       degree=args.precond_degree,
                                       permute=permute, inv_diag=inv_diag)
            scaled = " on D^-1 A" if inv_diag is not None else ""
            print(f"Preconditioner: Chebyshev(degree {precond.degree}, "
                  f"bounds [{precond.lmin:.4g}, {precond.lmax:.4g}])"
                  f"{scaled}")
        return inv_diag, precond

    def report_difference(x, xexact):
        if xexact is not None:
            diff = check_residual(x, xexact)
            print(f"Difference between computed and exact  = {diff:f}")

    iterations = 0
    with trace(args.trace):
        try:
            if param.bench == "cg":
                print("Test type: CG")
                b, xexact = make_vectors()
                inv_diag, precond = resolve_precond_pair()
                if args.nrhs > 1:
                    from sparsebench_tpu_torch.solvers.cg_multi import (
                        solve_cg_multi,
                    )

                    print(f"Blocked CG: {args.nrhs} right-hand sides")
                    res = solve_cg_multi(
                        A, b[:, None].repeat(1, args.nrhs),
                        itermax=param.itermax, eps=param.eps)
                    if xexact is not None:  # every column's exact solution
                        xexact = np.repeat(xexact[:, None], args.nrhs,
                                           axis=1)
                elif args.refine:
                    from sparsebench_tpu_torch.solvers.refine import (
                        solve_cg_refine,
                    )

                    res = solve_cg_refine(
                        A, b, A_lo=build_lo_matrix(param, args, A, csr,
                                                   policy, device),
                        outer_max=args.refine_sweeps,
                        inner_iters=param.itermax, eps=param.eps)
                elif args.checkpoint:
                    from sparsebench_tpu_torch.solvers.checkpoint import (
                        solve_cg_checkpointed,
                    )

                    res = solve_cg_checkpointed(
                        A, b, checkpoint_path=args.checkpoint,
                        checkpoint_every=args.checkpoint_every,
                        itermax=param.itermax, eps=param.eps)
                elif args.profile:
                    res = solve_cg_profiled(A, b, prof, itermax=param.itermax,
                                            eps=param.eps)
                else:
                    res = solve_cg(A, b, itermax=param.itermax, eps=param.eps,
                                   inv_diag=inv_diag, precond=precond,
                                   variant=args.cg_variant, sstep=args.sstep)
                    print(prof.report_aggregate(res.iterations,
                                                res.solve_seconds))
                iterations = res.iterations
                report_difference(res.x, xexact)
            elif param.bench == "spmv":
                print("Test type: SPMVM")
                bench_spmv(A, prof, dtype=policy.value, itermax=param.itermax,
                           fused_reps=20)
                iterations = param.itermax - 1 if param.itermax > 1 else 1
            elif param.bench == "gmres":
                from sparsebench_tpu_torch.solvers.gmres import solve_gmres

                print("Test type: GMRES")
                b = torch.ones(A.nr, dtype=policy.value, device=device)
                inv_diag, precond = resolve_precond_pair()
                res = solve_gmres(A, b, itermax=param.itermax, eps=param.eps,
                                  orth=args.orth, inv_diag=inv_diag,
                                  precond=precond, restart=args.restart)
                iterations = res.iterations
            elif param.bench == "cheb":
                from sparsebench_tpu_torch.solvers.chebyshev import (
                    solve_chebyshev,
                )

                print("Test type: CHEBFD")
                b, xexact = make_vectors()
                inv_diag = (make_inv_diag() if args.precond == "jacobi"
                            else None)
                res = solve_chebyshev(A, b, itermax=param.itermax,
                                      eps=param.eps, inv_diag=inv_diag)
                iterations = res.iterations
                report_difference(res.x, xexact)
            elif param.bench == "bicgstab":
                from sparsebench_tpu_torch.solvers.bicgstab import (
                    solve_bicgstab,
                )

                print("Test type: BICGSTAB")
                b, xexact = make_vectors()
                inv_diag, precond = resolve_precond_pair()
                res = solve_bicgstab(A, b, itermax=param.itermax,
                                     eps=param.eps, inv_diag=inv_diag,
                                     precond=precond)
                iterations = res.iterations
                report_difference(res.x, xexact)
            elif param.bench == "minres":
                from sparsebench_tpu_torch.solvers.minres import solve_minres

                print("Test type: MINRES")
                b, xexact = make_vectors()
                # Jacobi only: MINRES needs M SPD (cheb exits in _validate)
                inv_diag = (make_inv_diag() if args.precond == "jacobi"
                            else None)
                res = solve_minres(A, b, itermax=param.itermax,
                                   eps=param.eps, inv_diag=inv_diag)
                iterations = res.iterations
                report_difference(res.x, xexact)
        except ValueError as e:  # a solver that cannot take the options
            raise SystemExit(f"sparsebench_tpu_torch: {e}") from None
    if (args.profile and param.bench == "cg") or param.bench == "spmv":
        # gated to the benches that feed the timers (warned above)
        print(prof.report(iterations))
    return 0


if __name__ == "__main__":
    sys.exit(main())
