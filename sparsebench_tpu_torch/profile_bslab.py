"""K6 and K7, the bslab SpMV kernels, timed on a CUDA card, optionally
beside K6 built from another tree of this repository.

    python -m sparsebench_tpu_torch.profile_bslab [--cases 100,200,rgl]
        [--against DIR] [--reps 2]

Each case is built as the bench builds it, f32 x and bf16 values: the n^3
generated stencil (``100``, ``200``; ``BslabMatrix.from_stencil``) and the
RGL matrix of 2M rows (``rgl``: band 512, deg 16, seed 1; ``rgl_bslab``).
Every kernel is first checked bit for bit against ``bslab_spmv_torch``,
then timed: the better of ``reps`` CUDA-graph replays of 20 calls, CUDA
events. Beside each time: the bound (every stored array, x and y once,
``physical_spmv_bytes``, at 3.35 TB/s), the share of it, and cuSPARSE CSR
f32 on the same matrix (``torch.sparse_csr_tensor @ x``: a yardstick that
the port never calls). K7 runs with ``win_plan``'s unit.

``--against DIR`` builds DIR/sparsebench_tpu_torch/csrc/bslab_spmv.cu
(another tree of this repository, for instance the parent commit unpacked
with ``git archive`` into a directory that .gitignore lists) with this
tree's nvcc flags, and times its K6 in turns with this tree's: other,
this, this, other. Both trees' K6 share one C interface. The last line is
one JSON object of every time, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.base import physical_spmv_bytes
from sparsebench_tpu_torch.formats.bslab import BslabMatrix
from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops import bslab_spmv as ops
from sparsebench_tpu_torch.ops.bslab_spmv import (
    LANES,
    bslab_spmv,
    bslab_spmv_torch,
    bslab_spmv_win,
    win_plan,
)
from sparsebench_tpu_torch.profile_cg import replay_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, at 700 W
RGL_N = 2_000_000
CASES = ("100", "200", "rgl")


def build_other(tree: Path) -> ctypes.CDLL:
    """The kernel library of ``tree``'s csrc/bslab_spmv.cu, built with
    this tree's flags beside this tree's libraries."""
    csrc = tree / "sparsebench_tpu_torch" / "csrc"
    src = csrc / "bslab_spmv.cu"
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in [*sorted(csrc.glob("*.cuh")), src]:
        h.update(f.read_bytes())
    out = _build.BUILD_DIR / "other" / f"libbslab_spmv_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                        "-o", str(out), str(src)], check=True,
                       timeout=_build.NVCC_TIMEOUT_S)
    lib = ctypes.CDLL(str(out))
    lib.sb_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sb_cuda_error_string.restype = ctypes.c_char_p
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for sfx in ops._SUFFIX.values():
        fn = getattr(lib, f"sb_bslab_spmv_{sfx}")
        fn.argtypes = [p] * 9 + [i32] * 3 + [p, i64, p, i32, i32, i32, p]
        fn.restype = i32
    return lib


def other_k6(lib: ctypes.CDLL, sl, x, sub: int, lead: int):
    """K6 of the other tree's library, launched as bslab_spmv launches
    this tree's (the two share one C interface)."""
    sfx, x = ops._check("bslab_spmv", sl, x, sub)
    y = torch.empty((sl.n_tiles, sub, LANES), dtype=x.dtype, device=x.device)
    err = getattr(lib, f"sb_bslab_spmv_{sfx}")(
        *ops._args(sl, x, y, sub, lead),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "other bslab_spmv")
    return y


def matrix(case: str, dev: torch.device):
    f32 = DTypePolicy.from_names("f32")
    if case == "rgl":
        return rgl_bslab(RGL_N, 512, 16.0, 1, device=dev, policy=f32)[0]
    n = int(case)
    return BslabMatrix.from_stencil(n, n, n, device=dev, policy=f32)[0]


def csr_of(A):
    """The bslab matrix as a CSR tensor (f32 values, int32 indices), built
    on the device from its slices."""
    dev = A.device
    t = torch.arange(A.n_tiles, device=dev)[:, None, None, None]
    s = torch.arange(A.sub, device=dev)[None, None, :, None]
    lane = torch.arange(LANES, device=dev)[None, None, None, :]
    row = (t * A.sub + s) * LANES + lane
    rows, cols, vals = [], [], []
    for meta, v, lidx, dblk in ((A.meta_aff, A.vals_aff, None, None),
                                (A.meta_gen, A.vals_gen, A.lidx_gen, None),
                                (A.meta_wide, A.vals_wide, A.lidx_wide,
                                 A.dblk_wide)):
        if v.shape[1] == 0:
            continue
        blk = meta[:, :, 0].long()[:, :, None, None] + s - A.lead
        idx = ((lane + meta[:, :, 1].long()[:, :, None, None]) & (LANES - 1)
               if lidx is None else lidx.long())
        if dblk is not None:
            blk = blk + dblk.long()
        col = blk * LANES + idx
        keep = v != 0
        rows.append(row.expand_as(col)[keep])
        cols.append(col[keep])
        vals.append(v[keep].float())
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    order = torch.argsort(r * A.nc + c)
    r, c, v = r[order], c[order], v[order]
    crow = torch.zeros(A.nr + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=A.nr), 0)
    return torch.sparse_csr_tensor(crow.to(torch.int32), c.to(torch.int32), v,
                                   (A.nr, A.nc), check_invariants=False)


def best_ms(fn, reps: int) -> float:
    return min(replay_ms(fn) for _ in range(reps))


def profile_case(case: str, other, reps: int, dev, gpu: str) -> dict:
    A = matrix(case, dev)
    sl = A.slices
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        A.nc).astype(np.float32)).to(dev)
    y_ref = bslab_spmv_torch(sl, x, sub=A.sub, lead=A.lead, x_rows=A.x_rows)
    plan = win_plan(sl, A.w_blocks, x.dtype)
    kernels = {
        "K6": lambda: bslab_spmv(sl, x, sub=A.sub, lead=A.lead),
        "K7": lambda: bslab_spmv_win(A.wchunk, sl, x, sub=A.sub, lead=A.lead,
                                     w_blocks=A.w_blocks),
    }
    if other:
        kernels["K6 other"] = lambda: other_k6(other, sl, x, A.sub, A.lead)
    for key, fn in kernels.items():
        y = fn()
        torch.cuda.synchronize()
        if not torch.equal(y.view(torch.int32), y_ref.view(torch.int32)):
            raise SystemExit(f"{key} differs from bslab_spmv_torch on {case}")
    ms = {}
    if other:  # in turns: other, this, this, other
        o1 = best_ms(kernels["K6 other"], reps)
        t1 = best_ms(kernels["K6"], reps)
        t2 = best_ms(kernels["K6"], reps)
        o2 = best_ms(kernels["K6 other"], reps)
        ms["K6"], ms["K6 other"] = min(t1, t2), min(o1, o2)
    else:
        ms["K6"] = best_ms(kernels["K6"], reps)
    ms["K7"] = best_ms(kernels["K7"], reps)
    csr = csr_of(A)
    ms["cuSPARSE"] = best_ms(lambda: csr @ x, reps)
    phys = physical_spmv_bytes(A, 4)
    bound = phys / HBM_BYTES_PER_S * 1e3
    label = "RGL 2M" if case == "rgl" else f"{case}^3"
    shares = ", ".join(f"{k} {v:.6f} ms ({bound / v:.3f} of the bound)"
                       for k, v in ms.items())
    print(f"[profile_bslab] {label} (slices {A.s_aff}/{A.s_gen}/{A.s_wide}, "
          f"W {A.w_blocks}, K7 cluster {plan.cluster} ring {plan.ring}): "
          f"{shares}; bound {bound:.6f} ms ({phys} B) | {gpu}", flush=True)
    return dict(ms, bound_ms=bound, cluster=plan.cluster, ring=plan.ring)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparsebench_tpu_torch.profile_bslab")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated of 100, 200, rgl; default all")
    ap.add_argument("--against", type=Path, default=None,
                    help="another tree of this repository whose K6 to time "
                    "in turns with this tree's")
    ap.add_argument("--reps", type=int, default=2,
                    help="CUDA-graph replays a time; default 2")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    if not set(cases) <= set(CASES):
        ap.error(f"--cases takes {', '.join(CASES)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_bslab needs a CUDA card")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    other = build_other(args.against) if args.against else None
    dev = torch.device("cuda")
    out = {case: profile_case(case, other, args.reps, dev, gpu)
           for case in cases}
    print(json.dumps({"gpu": gpu, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
