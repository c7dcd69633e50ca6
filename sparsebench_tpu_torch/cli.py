"""Command-line entry point (reference src/main.c; counterpart of
sparsebench_tpu/cli.py).

The reference flags ``-h -f -m -t -x -y -z -i -e`` plus ``--fmt``,
``--dtype``, ``--index-dtype``, ``--impl``, ``--device`` and ``--trace``.
Flow (src/main.c:83-230): banner -> matrix (the generated stencil straight
into DIA or as the matrix-free ``stencil`` operator, or a .mtx/.bmx file
through the host CSR into DIA) -> profiler factors -> CG solve (variant
``standard``, ``cs``, ``fused`` or ``vmem``) or SpMV bench -> report.

The default device is ``cuda``; without CUDA the run exits with an error
instead of running on the CPU (``--device cpu`` runs the plain PyTorch
path). A ``-t``, ``--fmt`` or ``--cg-variant`` choice of the JAX CLI that is
not ported exits and names the ROADMAP.md item that ports it; the JAX
CLI's other flags are absent, so argparse rejects them.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from sparsebench_tpu_torch.config import (
    DTypePolicy,
    Parameter,
    print_parameter,
    read_parameter,
    resolve_device,
)
from sparsebench_tpu_torch.formats.registry import NOT_PORTED
from sparsebench_tpu_torch.solvers.cg import CG_LOOPS, CG_VARIANTS_NOT_PORTED
from sparsebench_tpu_torch.version import __version__

BANNER = "SparseBench — PyTorch/CUDA port of sparsebench_tpu"

BENCHES = ["cg", "spmv", "gmres", "cheb", "bicgstab", "minres"]
FORMATS = ["auto", "dia", "stencil", *NOT_PORTED]


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
                    help="Benchmark type. Default cg (ported: cg, spmv).")
    ap.add_argument("-x", type=int, default=None, help="Generated size in x")
    ap.add_argument("-y", type=int, default=None, help="Generated size in y")
    ap.add_argument("-z", type=int, default=None, help="Generated size in z")
    ap.add_argument("-i", type=int, default=None, dest="itermax",
                    help="Number of solver iterations. Default 150.")
    ap.add_argument("-e", type=float, default=None, dest="eps",
                    help="Convergence criteria epsilon. Default 0.0.")
    # runtime options (compile-time in the reference, config.mk:1-8)
    ap.add_argument("--fmt", default=None, choices=FORMATS,
                    help="Matrix format. Default auto = dia (ported: auto, "
                    "dia, stencil; stencil is matrix-free and takes "
                    "generated problems only).")
    ap.add_argument("--dtype", default=None, choices=["f64", "f32", "bf16"],
                    help="Value dtype (reference FLOAT_TYPE). Default f32.")
    ap.add_argument("--index-dtype", default=None, choices=["i32", "i64"],
                    help="Index dtype of the reference byte model. Default i32.")
    ap.add_argument("--impl", default="auto",
                    choices=["auto", "torch", "kernel"],
                    help="Kernel implementation: the CUDA kernels or their "
                    "plain PyTorch versions. Default auto: kernel on CUDA, "
                    "torch on the CPU.")
    ap.add_argument("--device", default="cuda",
                    help="torch device, cuda (default) or cpu. Without CUDA "
                    "the default exits with an error.")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="Write a torch.profiler Chrome trace to DIR")
    ap.add_argument("--cg-variant", default="standard", dest="cg_variant",
                    choices=[*CG_LOOPS, *CG_VARIANTS_NOT_PORTED],
                    help="CG formulation: standard, cs (single reduction; "
                    "SB_FUSED_CS=1 fuses it on --fmt stencil), fused and "
                    "vmem (--fmt stencil only; vmem while r and p fit the "
                    "L2)")
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
        ("index_dtype", "index_dtype"), ("bench", "bench"),
    ]:
        v = getattr(args, key_cli, None)
        if v is not None:
            setattr(param, key_param, v)
    return param


def _refuse_unported(args: argparse.Namespace, param: Parameter) -> None:
    """SystemExit naming the ROADMAP.md item for a choice that is not
    ported (a bench, format or CG variant, or a .par file's shards or
    generateRGL)."""
    if args.cg_variant in CG_VARIANTS_NOT_PORTED:
        raise SystemExit(
            f"--cg-variant {args.cg_variant} is not ported to "
            "sparsebench_tpu_torch yet "
            f"(ROADMAP.md {CG_VARIANTS_NOT_PORTED[args.cg_variant]})"
        )
    if param.bench not in ("cg", "spmv"):
        raise SystemExit(
            f"-t {param.bench} is not ported to sparsebench_tpu_torch yet "
            "(ROADMAP.md Queue 1 item 9)"
        )
    if param.shards > 1:
        raise SystemExit("shards > 1 is not ported to sparsebench_tpu_torch "
                         "yet (ROADMAP.md Queue 1 item 11)")
    if param.filename == "generateRGL":
        raise SystemExit("generateRGL is not ported to sparsebench_tpu_torch "
                         "yet (ROADMAP.md Queue 1 item 8)")
    if param.fmt not in ("auto", "dia", "stencil"):
        from sparsebench_tpu_torch.formats import get_format

        try:
            get_format(param.fmt)
        except (NotImplementedError, ValueError) as e:
            raise SystemExit(str(e)) from None


def init_matrix(param: Parameter):
    """Reference initMatrix (src/main.c:54-81) for matrix files: the host
    CSR of a .mtx or .bmx file."""
    from sparsebench_tpu_torch.host import read_bmx, read_mm

    fn = param.filename
    if fn.endswith(".mtx"):
        print("Read MTX matrix")
        return read_mm(fn)
    if fn.endswith(".bmx"):
        print("Read BMX matrix")
        return read_bmx(fn)
    raise SystemExit(f"Unknown matrix file format: {fn}")


def main(argv: Optional[list] = None) -> int:
    ap = build_argparser()
    args = ap.parse_args(argv)
    param = apply_args(Parameter(), args)
    _refuse_unported(args, param)

    from sparsebench_tpu_torch.formats import from_csr
    from sparsebench_tpu_torch.formats.base import physical_spmv_bytes
    from sparsebench_tpu_torch.formats.dia import (
        DiaMatrix,
        DiaUnsuitableError,
        resolve_impl,
    )
    from sparsebench_tpu_torch.formats.stencil import StencilOperator
    from sparsebench_tpu_torch.profiler import Profiler, trace
    from sparsebench_tpu_torch.solvers.cg import (
        check_residual,
        init_vectors,
        solve_cg,
    )
    from sparsebench_tpu_torch.solvers.profiled import bench_spmv

    policy = DTypePolicy.from_names(param.dtype, param.index_dtype)
    try:
        device = resolve_device(args.device)
        impl = resolve_impl(args.impl, device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"sparsebench_tpu_torch: {e}") from None
    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    generated = param.filename in ("generate", "generate7P")
    param.fmt = "dia" if param.fmt == "auto" else param.fmt

    print(BANNER)
    print(
        f"sparsebench_tpu_torch {__version__} | format {param.fmt} | "
        f"precision {param.dtype}/{param.index_dtype} | {device_name} | "
        f"spmv {impl}"
    )
    print(print_parameter(param))  # reference printParameter

    t0 = time.perf_counter()
    csr = None
    row_counts = None
    if generated:
        # analytic on-device build, no CSR: DIA, or the matrix-free operator
        build = StencilOperator if param.fmt == "stencil" else DiaMatrix
        A, row_counts = build.from_stencil(
            param.nx, param.ny, param.nz, device=device,
            use_7pt=param.filename == "generate7P", policy=policy, impl=impl,
        )
        total_nr, model_nnz = A.total_nr, 27 * A.total_nr
    else:
        csr = init_matrix(param)
        try:
            A = from_csr(param.fmt, csr, policy, device=device, impl=impl)
        except DiaUnsuitableError as e:
            raise SystemExit(
                f"{e}: this matrix needs the bslab format, which is not "
                "ported to sparsebench_tpu_torch yet (ROADMAP.md Queue 1 "
                "item 7)"
            ) from None
        except ValueError as e:  # the matrix-free stencil takes no file
            raise SystemExit(f"sparsebench_tpu_torch: {e}") from None
        total_nr = csr.total_nr
        model_nnz = (
            csr.model_total_nnz if csr.model_total_nnz > 0 else csr.total_nnz
        )
    print(f"Setup took {time.perf_counter() - t0:.2f}s (format {param.fmt})")
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

    iterations = 0
    with trace(args.trace):
        if param.bench == "cg":
            print("Test type: CG")
            _x0, b, xexact = init_vectors(
                csr, dtype=policy.host_value, generated=generated,
                row_lengths=row_counts,
            )
            b = torch.from_numpy(b).to(device=device, dtype=policy.value)
            try:
                res = solve_cg(A, b, itermax=param.itermax, eps=param.eps,
                               variant=args.cg_variant)
            except ValueError as e:  # a variant the operator cannot run
                raise SystemExit(f"sparsebench_tpu_torch: {e}") from None
            print(prof.report_aggregate(res.iterations, res.solve_seconds))
            iterations = res.iterations
            if xexact is not None:
                diff = check_residual(res.x, xexact)
                print(f"Difference between computed and exact  = {diff:f}")
        else:
            print("Test type: SPMVM")
            bench_spmv(A, prof, dtype=policy.value, itermax=param.itermax,
                       fused_reps=20)
            iterations = param.itermax - 1 if param.itermax > 1 else 1
    if param.bench == "spmv":
        print(prof.report(iterations))
    return 0


if __name__ == "__main__":
    sys.exit(main())
