"""The bslab SpMV kernels K6 and K7 and the bsell SpMV kernels K9-K11 timed
on a CUDA card, optionally beside another tree's K6, K9 and K10.

    python -m sparsebench_tpu_torch.profile_bslab [--cases 100,200,rgl,
        bsell100,bsell100s,bsell200,bsell300] [--against DIR] [--reps 2]

Each case is built as the bench builds it, f32 x and bf16 values: the n^3
generated stencil as bslab (``100``, ``200``; ``BslabMatrix.from_stencil``)
and the RGL matrix of 2M rows (``rgl``: band 512, deg 16, seed 1;
``rgl_bslab``); the stencil as bsell through the host CSR at 100^3
(``bsell100``, the CLI's build) and on the device at 100^3 and 200^3
(``bsell100s``, ``bsell200``; ``BsellMatrix.from_stencil``) and, when
asked for, at 300^3 (``bsell300``: x of 108 MB, beyond the 50 MB L2; no
cuSPARSE beside it). Every kernel
is first checked bit for bit against its plain version (``bslab_spmv_torch``,
``bsell_spmv_torch``), then timed: the better of ``reps`` CUDA-graph
replays of 20 calls, CUDA events. Beside each time: the bound (bslab: every
stored array, x and y once, ``physical_spmv_bytes``; bsell, K9-K11
alike: the planes, wchunk, the windowed layout's x and y once; at 3.35
TB/s), the share of it, and cuSPARSE CSR f32 on the same matrix
(``torch.sparse_csr_tensor @ x``, built from the bslab layout of the same
stencil for the bsell cases: a yardstick that the port never calls).
K7, K10 and K11 run with ``win_plan``'s unit.

``--against DIR`` builds DIR/sparsebench_tpu_torch/csrc/bslab_spmv.cu and
bsell_spmv.cu (another tree of this repository, for instance the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists) with this tree's nvcc flags, and times its K6, K9 and K10 in turns
with this tree's: other, this, this, other. The other tree's K6 and K9
share this tree's C interfaces; its K10 is called with the arguments its
source declares after ``w_blocks`` (none, or this tree's unit of blocks, or
that and a ring depth of two), and where it refuses the window it is left
out. (``lib_k8`` calls another tree's K8, ``lib_k2`` and ``lib_k3``
its stencil kernels K2 and K3, and ``lib_k5`` its one-launch CG K5, the
same way, for ``chip_smoke.py --against`` and ``profile_cg``.)
The last line is one JSON object of every time, with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from sparsebench_tpu_torch.config import DTypePolicy
from sparsebench_tpu_torch.formats.base import physical_spmv_bytes
from sparsebench_tpu_torch.formats.bslab import BslabMatrix
from sparsebench_tpu_torch.formats.bsell import BsellMatrix
from sparsebench_tpu_torch.formats.rgl_build import rgl_bslab
from sparsebench_tpu_torch.host import generate_stencil
from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops import bsell_spmv as bsell_ops
from sparsebench_tpu_torch.ops import bslab_spmv as ops
from sparsebench_tpu_torch.ops import dia_spmm as spmm_ops
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
BSLAB_CASES = ("100", "200", "rgl")
BSELL_CASES = ("bsell100", "bsell100s", "bsell200", "bsell300")
CASES = BSLAB_CASES + BSELL_CASES
DEFAULT_CASES = CASES[:-1]  # bsell300 (x beyond the L2) when asked for


def k10_unit_args(src: str) -> int:
    """The int arguments that a bsell_spmv.cu source's K10 entry point takes
    after ``w_blocks``: 0 before K10 took a unit of blocks, 1 (the unit's
    blocks), or 2 (those and the ring's depth)."""
    m = re.search(r"sb_bsell_spmv_win2_##SUFFIX\(SB_BSELL_ARGS,(.*?)\)",
                  src, re.S)
    if m is None:
        raise ValueError("no K10 entry point in the other tree's source")
    return len(re.findall(r"\bint\b", m.group(1))) - 1


def build_other(tree: Path, name: str = "bslab_spmv") -> ctypes.CDLL:
    """The kernel library of ``tree``'s csrc/<name>.cu, built with this
    tree's flags beside this tree's libraries."""
    csrc = tree / "sparsebench_tpu_torch" / "csrc"
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in [*sorted(csrc.glob("*.cuh")), src]:
        h.update(f.read_bytes())
    out = _build.BUILD_DIR / "other" / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc),
                        "-o", str(out), str(src)], check=True,
                       timeout=_build.NVCC_TIMEOUT_S)
    lib = ctypes.CDLL(str(out))
    lib.sb_cuda_error_string.argtypes = [ctypes.c_int]
    lib.sb_cuda_error_string.restype = ctypes.c_char_p
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if name == "stencil":
        # K2 (x, y, parts) and K3 (r, p, beta, pn, w, parts), then nx, ny,
        # nz, use_7pt and, where the source takes one, the tile plan (r,
        # tz, grid, smem); before the march, one block of 256 points each
        lib.stencil_takes_plan = "SB_STENCIL_PLAN" in src.read_text()
        plan = [i32, i32, i64, i64] if lib.stencil_takes_plan else []
        for sfx in ("bf16", "f32", "f64"):
            fn = getattr(lib, f"sb_stencil_apply_{sfx}")
            fn.argtypes = [p] * 3 + [i32] * 4 + plan + [p]
            fn.restype = i32
            fn = getattr(lib, f"sb_stencil_axpy_apply_dots_{sfx}")
            fn.argtypes = [p] * 6 + [i32] * 4 + plan + [p]
            fn.restype = i32
        return lib
    if name == "stencil_cg_vmem":
        # K5: this tree's interface (ops/stencil_cg_vmem.py ARGTYPES: the
        # plan with its form); before the ring, the plan (rows, tz, blocks,
        # smem) after itermax; before the march, (r, p, x, hist, parts,
        # eps, nx, ny, nz, use_7pt, itermax, blocks)
        text = src.read_text()
        if "long long smem, int ring" in text:
            lib.k5_plan = "form"
            from sparsebench_tpu_torch.ops import stencil_cg_vmem as scv

            return scv.bind(lib)
        lib.k5_plan = "plan" if "SB_CG_PLAN" in text else None
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"sb_stencil_cg_vmem_{sfx}")
            fn.argtypes = ([p] * 8 + [i32] * 7 + [i64, i64, p]
                           if lib.k5_plan else [p] * 6 + [i32] * 6 + [p])
            fn.restype = i32
            fn = getattr(lib, f"sb_stencil_cg_vmem_blocks_{sfx}")
            fn.argtypes = ([i32, i32, i64, ctypes.POINTER(i32)]
                           if lib.k5_plan else [ctypes.POINTER(i32)])
            fn.restype = i32
        return lib
    for sfx in ops._SUFFIX.values():
        if name == "bslab_spmv":
            fn = getattr(lib, f"sb_bslab_spmv_{sfx}")
            fn.argtypes = [p] * 9 + [i32] * 3 + [p, i64, p, i32, i32, i32, p]
        elif name == "dia_spmm":
            # K8: this tree's interface (ops/dia_spmm.py ARGTYPES: the
            # form and the staged layout); before the staged form the
            # chunk plan (quad, chunks, start, d0, length, shift) or,
            # before K8 took a plan, ndiag and the offsets
            text = src.read_text()
            lib.k8_plan = ("form" if "int form" in text else
                           "quad" if "int quad" in text else None)
            fn = getattr(lib, f"sb_dia_spmm_{sfx}")
            fn.argtypes = (spmm_ops.ARGTYPES if lib.k8_plan == "form" else
                           [p, p, p, i64, i64, i32, i64, i64, i32, i32,
                            ctypes.POINTER(i64)] + [ctypes.POINTER(i32)] * 3
                           + [p] if lib.k8_plan else
                           [p, p, p, i64, i64, i32, ctypes.POINTER(i64), i32,
                            i64, i64, p])
        else:
            # K9: blocks, base, x, vals, lidx, y, n_tiles, s_max, x_rows,
            # stream
            fn = getattr(lib, f"sb_bsell_spmv_{sfx}")
            fn.argtypes = [p] * 6 + [i32] * 3 + [p]
            fn.restype = i32
            # K10: blocks, wchunk, x, vals, lidx, y, n_tiles, s_max, x_rows,
            # w_blocks, [unit blocks, [ring,]] stream
            lib.k10_unit_args = k10_unit_args(src.read_text())
            fn = getattr(lib, f"sb_bsell_spmv_win2_{sfx}")
            fn.argtypes = [p] * 6 + [i32] * (4 + lib.k10_unit_args) + [p]
        fn.restype = i32
    return lib


def _other_stencil_plan(lib: ctypes.CDLL, v, nx: int, ny: int, nz: int):
    """(the plan arguments, the count of partials) of another tree's K2 or
    K3: this tree's ``device_plan`` where its source takes a plan, else
    none and one partial a 256-point block."""
    from sparsebench_tpu_torch.ops import stencil as st

    if not lib.stencil_takes_plan:
        return (), -(-(nx * ny * nz) // 256)
    plan = st.device_plan(v, nx, ny, nz)
    return (plan.r, plan.tz, plan.grid, plan.smem), plan.grid


def lib_k2(lib: ctypes.CDLL, x, nx: int, ny: int, nz: int,
           use_7pt: bool = False, out=None):
    """K2 of another tree's library on this tree's inputs: y (into ``out``
    when given, as ``lib_k9``), through the interface its source
    declares."""
    from sparsebench_tpu_torch.ops import stencil as st

    y = out if out is not None else torch.empty_like(x)
    plan, _ = _other_stencil_plan(lib, x, nx, ny, nz)
    err = getattr(lib, f"sb_stencil_apply_{st.DTYPE_SUFFIX[x.dtype]}")(
        x.data_ptr(), y.data_ptr(), None, nx, ny, nz, int(use_7pt), *plan,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "other stencil_apply")
    return y


def lib_k3(lib: ctypes.CDLL, r, p, beta, nx: int, ny: int, nz: int,
           use_7pt: bool = False):
    """K3 of another tree's library on this tree's inputs: (p', w, delta)
    through the interface its source declares; beta a 0-d tensor at the
    compute width."""
    from sparsebench_tpu_torch.ops import stencil as st

    cdt = st.compute_dtype(r.dtype)
    plan, n_parts = _other_stencil_plan(lib, r, nx, ny, nz)
    pn, w = torch.empty_like(r), torch.empty_like(r)
    parts = torch.empty(n_parts, dtype=cdt, device=r.device)
    beta = beta.to(cdt).reshape(1)
    err = getattr(lib, f"sb_stencil_axpy_apply_dots_{st.DTYPE_SUFFIX[r.dtype]}")(
        r.data_ptr(), p.data_ptr(), beta.data_ptr(), pn.data_ptr(),
        w.data_ptr(), parts.data_ptr(), nx, ny, nz, int(use_7pt), *plan,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(lib, err, "other stencil_axpy_apply_dots")
    return pn, w, torch.sum(parts)


def lib_k5(lib: ctypes.CDLL, r0, x0, eps: float, nx: int, ny: int, nz: int,
           itermax: int, use_7pt: bool = False):
    """K5 of another tree's library on this tree's inputs: (x, hist),
    through the interface its source declares; where it takes a plan,
    ``cg_plan`` at the blocks its own kernel fits on the card (the march
    where it has no ring form)."""
    from sparsebench_tpu_torch.ops import stencil_cg_vmem as scv

    sfx = scv._SUFFIX[r0.dtype]
    dev = r0.device
    blocks = ctypes.c_int(0)
    r, x = r0.clone(), x0.clone()
    hist = torch.empty(itermax, dtype=r0.dtype, device=dev)
    eps_t = torch.full((1,), eps, dtype=r0.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lib.k5_plan is not None:
        # this tree's default plan, or the march where the tree has no ring
        itemsize = r0.element_size()
        form = "march" if lib.k5_plan == "plan" else None
        shape = scv.cg_plan(nx, ny, nz, itemsize, 1, form=form)
        ring = (int(shape.form == "ring"),) if lib.k5_plan == "form" else ()
        err = getattr(lib, f"sb_stencil_cg_vmem_blocks_{sfx}")(
            shape.r, int(use_7pt), *ring, shape.smem, ctypes.byref(blocks))
        _build.check(lib, err, "other stencil_cg_vmem occupancy")
        plan = scv.cg_plan(nx, ny, nz, itemsize, blocks.value,
                           form=shape.form)
        p0, p1, w = torch.zeros_like(r), torch.empty_like(r), torch.empty_like(r)
        parts = torch.empty(plan.parts, dtype=r0.dtype, device=dev)
        err = getattr(lib, f"sb_stencil_cg_vmem_{sfx}")(
            r.data_ptr(), p0.data_ptr(), p1.data_ptr(), w.data_ptr(),
            x.data_ptr(), hist.data_ptr(), parts.data_ptr(), eps_t.data_ptr(),
            nx, ny, nz, int(use_7pt), itermax, plan.r, plan.tz, plan.blocks,
            plan.smem, *ring, stream)
    else:
        err = getattr(lib, f"sb_stencil_cg_vmem_blocks_{sfx}")(
            ctypes.byref(blocks))
        _build.check(lib, err, "other stencil_cg_vmem occupancy")
        p = torch.zeros_like(r)
        parts = torch.empty(2 * blocks.value, dtype=r0.dtype, device=dev)
        err = getattr(lib, f"sb_stencil_cg_vmem_{sfx}")(
            r.data_ptr(), p.data_ptr(), x.data_ptr(), hist.data_ptr(),
            parts.data_ptr(), eps_t.data_ptr(), nx, ny, nz, int(use_7pt),
            itermax, blocks.value, stream)
    _build.check(lib, err, "other stencil_cg_vmem")
    return x, hist


def lib_k9(lib: ctypes.CDLL, A, x2d, vals, out=None):
    """K9 of another tree's library on this tree's inputs: y (written into
    ``out`` when given: a check fills it with NaN first, so that a launch
    that writes nothing shows)."""
    n_tiles = A.n_tiles
    sfx = bsell_ops._check("bsell_spmv", A.blocks, A.win_base,
                           (n_tiles, 1, 8), x2d, vals, A.lidx)
    y = out if out is not None else torch.empty(
        (n_tiles, 8, LANES), dtype=x2d.dtype, device=x2d.device)
    err = getattr(lib, f"sb_bsell_spmv_{sfx}")(
        A.blocks.data_ptr(), A.win_base.data_ptr(), x2d.data_ptr(),
        vals.data_ptr(), A.lidx.data_ptr(), y.data_ptr(), n_tiles, A.s_max,
        x2d.shape[0], torch.cuda.current_stream(x2d.device).cuda_stream)
    _build.check(lib, err, "other bsell_spmv")
    return y


def lib_k8(lib: ctypes.CDLL, data, X, offsets, nr: int, out=None):
    """K8 of another tree's library on this tree's inputs (a contiguous
    (k, nr) X): Y, through the interface its source declares (into ``out``
    when given, as ``lib_k9``)."""
    sfx = {torch.bfloat16: "bf16_f32", torch.float32: "f32_f32",
           torch.float64: "f64_f64"}[data.dtype]
    k = X.shape[0]
    Y = out if out is not None else torch.empty((k, nr), dtype=X.dtype,
                                                device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    offsets = tuple(int(o) for o in offsets)
    head = (data.data_ptr(), X.data_ptr(), Y.data_ptr(), nr, data.shape[1])
    if lib.k8_plan:
        aligned = all(t.data_ptr() % spmm_ops.ALIGN == 0 for t in (data, X, Y))
        _form, plan = spmm_ops._plan_args(
            offsets, nr, data.shape[1], X.shape[1], nr, aligned, k,
            (data.element_size(), X.element_size()))
        if lib.k8_plan == "quad":  # four rows a thread wherever it stages
            plan = (int(plan[0] > 0), *plan[1:-1])
        err = getattr(lib, f"sb_dia_spmm_{sfx}")(
            *head, k, X.shape[1], nr, *plan, stream)
    else:
        arr = (ctypes.c_longlong * len(offsets))(*offsets)
        err = getattr(lib, f"sb_dia_spmm_{sfx}")(
            *head, len(offsets), arr, k, X.shape[1], nr, stream)
    _build.check(lib, err, "other dia_spmm")
    return Y


def lib_k10(lib: ctypes.CDLL, A, xw, vals, out=None):
    """K10 of another tree's library on this tree's inputs, in this tree's
    unit (``win_plan``) where it takes one: y (into ``out`` when given, as
    ``lib_k9``), or None where it refuses the launch."""
    n_tiles = A.n_tiles
    sfx = bsell_ops._check("bsell_spmv_win2", A.blocks, A.wchunk,
                           (n_tiles,), xw, vals, A.lidx)
    y = out if out is not None else torch.empty(
        (n_tiles, 8, LANES), dtype=xw.dtype, device=xw.device)
    unit = (bsell_ops.win_plan(A.w_blocks, xw.dtype).cluster,
            2)[:lib.k10_unit_args]
    err = getattr(lib, f"sb_bsell_spmv_win2_{sfx}")(
        A.blocks.data_ptr(), A.wchunk.data_ptr(), xw.data_ptr(),
        vals.data_ptr(), A.lidx.data_ptr(), y.data_ptr(), n_tiles,
        A.s_max, xw.shape[0], A.w_blocks, *unit,
        torch.cuda.current_stream(xw.device).cuda_stream)
    return y if err == 0 else None


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
        y.fill_(float("nan"))  # the next kernel's output may reuse it
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


def bsell_matrix(case: str, dev: torch.device):
    f32 = DTypePolicy.from_names("f32")
    if case == "bsell100":
        return BsellMatrix.from_csr(generate_stencil(100, 100, 100), f32,
                                    device=dev)
    n = {"bsell100s": 100, "bsell200": 200, "bsell300": 300}[case]
    return BsellMatrix.from_stencil(n, n, n, device=dev, policy=f32)[0]


def windowed_bytes(A) -> int:
    """What a windowed bsell call must move: the value, index and block
    planes, wchunk, the windowed layout's x and y, each once (f32 x)."""
    planes = sum(t.numel() * t.element_size()
                 for t in (A.vals, A.lidx, A.blocks))
    return (planes + 4 * A.wchunk.numel() + 4 * A.xw_rows * LANES
            + 4 * A.n_tiles * 8 * LANES)


def in_turns(a, b, reps: int):
    """(best ms of a, best ms of b), timed b, a, a, b."""
    o1, t1, t2, o2 = (best_ms(f, reps) for f in (b, a, a, b))
    return min(t1, t2), min(o1, o2)


def profile_bsell(case: str, other, reps: int, dev, gpu: str) -> dict:
    A = bsell_matrix(case, dev)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        A.nc).astype(np.float32)).to(dev)
    x2d = A.padded_x(x, A.nc_pad // LANES)
    xw = A.padded_x(x, A.xw_rows)
    vals = A.vals
    y_ref = bsell_ops.bsell_spmv_torch(A.blocks, A.win_base, x2d, vals,
                                       A.lidx)
    plan = bsell_ops.win_plan(A.w_blocks, x.dtype)
    kernels = {
        "K9": lambda: bsell_ops.bsell_spmv(A.blocks, A.win_base, x2d, vals,
                                           A.lidx),
        "K10": lambda: bsell_ops.bsell_spmv_win2(
            A.wchunk, A.blocks, xw, vals, A.lidx, w_blocks=A.w_blocks),
        "K11": lambda: bsell_ops.bsell_spmv_windowed(
            A.wchunk, A.blocks, xw, vals, A.lidx, w_blocks=A.w_blocks),
    }
    if other is not None:
        kernels["K9 other"] = lambda: lib_k9(other, A, x2d, vals)
        if lib_k10(other, A, xw, vals) is None:
            print(f"[profile_bslab] {case}: the other tree's K10 refused the "
                  f"window of 2*{A.w_blocks} rows", flush=True)
        else:
            kernels["K10 other"] = lambda: lib_k10(other, A, xw, vals)
    for key, fn in kernels.items():
        y = fn()
        torch.cuda.synchronize()
        if not torch.equal(y.view(torch.int32), y_ref.view(torch.int32)):
            raise SystemExit(f"{key} differs from bsell_spmv_torch on {case}")
        y.fill_(float("nan"))  # the next kernel's output may reuse it
    if "K9 other" in kernels:
        ms = dict(zip(("K9", "K9 other"), in_turns(kernels["K9"],
                                                   kernels["K9 other"], reps)))
    else:
        ms = {"K9": best_ms(kernels["K9"], reps)}
    if "K10 other" in kernels:
        ms["K10"], ms["K10 other"] = in_turns(kernels["K10"],
                                              kernels["K10 other"], reps)
    else:
        ms["K10"] = best_ms(kernels["K10"], reps)
    ms["K11"] = best_ms(kernels["K11"], reps)
    # cuSPARSE on the same stencil, from its bslab build (not at 300^3,
    # whose CSR build would hold some 20 GB)
    if case != "bsell300":
        csr = csr_of(matrix("100" if case != "bsell200" else "200", dev))
        ms["cuSPARSE"] = best_ms(lambda: csr @ x, reps)
        del csr
    nbytes = windowed_bytes(A)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    shares = ", ".join(f"{k} {v:.6f} ms ({bound / v:.3f} of the bound)"
                       for k, v in ms.items())
    print(f"[profile_bslab] {case} ({A.n_tiles} tiles x {A.s_max} slices, W "
          f"{A.w_blocks}, K10 unit of {plan.cluster} blocks): "
          f"{shares}; bound {bound:.6f} ms ({nbytes} B) | {gpu}", flush=True)
    out = dict(ms, bound_ms=bound, cluster=plan.cluster)
    del A, x, x2d, xw, vals, y_ref
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sparsebench_tpu_torch.profile_bslab")
    ap.add_argument("--cases", default=",".join(DEFAULT_CASES),
                    help=f"comma-separated of {', '.join(CASES)}; default "
                    "all but bsell300")
    ap.add_argument("--against", type=Path, default=None,
                    help="another tree of this repository whose K6, K9 and "
                    "K10 to time in turns with this tree's")
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
    other_k10 = (build_other(args.against, "bsell_spmv") if args.against
                 else None)
    dev = torch.device("cuda")
    out = {case: (profile_bsell(case, other_k10, args.reps, dev, gpu)
                  if case in BSELL_CASES
                  else profile_case(case, other, args.reps, dev, gpu))
           for case in cases}
    print(json.dumps({"gpu": gpu, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
