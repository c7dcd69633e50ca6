"""Fused vector update of single-reduction CG: the CUDA kernel K4 and its
plain PyTorch version.

Counterpart of sparsebench_tpu/ops/cg_fused.py (``cs_update_pallas``). The
kernel is ``csrc/cg_fused.cu``. The Chronopoulos-Gear body (solvers/cg.py
``cg_cs_loop``) runs four dependent updates,

    p' = u + beta p;  s' = w + beta s;  x' = x + alpha p';  r' = r - alpha s'

and the kernel does them in one pass, 6 reads and 4 writes. alpha and beta
are f32, as the JAX package stacks them, widened to the compute width (f32
for bf16/f32 vectors, f64 for f64); bf16 vectors are computed in f32 and
stored as bf16. Any length works: the JAX kernel's multiple-of-1024 rule is
a TPU tiling rule.

``cs_update`` is the wrapper: CPU tensors go to ``cs_update_torch``, CUDA
tensors launch the kernel or raise; ``cs_update.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparsebench_tpu_torch.ops import _build
from sparsebench_tpu_torch.ops.stencil import (
    DTYPE_SUFFIX,
    compute_dtype,
    on_cpu,
)


def cs_update_torch(u, p, w, s, x, r, alpha, beta):
    """Plain version of K4: (p', s', x', r') in the vectors' dtype."""
    cdt = compute_dtype(u.dtype)
    al = torch.as_tensor(alpha, device=u.device).to(torch.float32).to(cdt)
    be = torch.as_tensor(beta, device=u.device).to(torch.float32).to(cdt)
    pv = u.to(cdt) + be * p.to(cdt)
    sv = w.to(cdt) + be * s.to(cdt)
    x2 = x.to(cdt) + al * pv
    r2 = r.to(cdt) - al * sv
    return tuple(v.to(u.dtype) for v in (pv, sv, x2, r2))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("cg_fused")
    p = ctypes.c_void_p
    for sfx in DTYPE_SUFFIX.values():
        fn = getattr(lib, f"sb_cs_update_{sfx}")
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return lib


def cs_update(u, p, w, s, x, r, alpha, beta):
    """K4: one pass computing (p', s', x', r'); see the module docstring."""
    vecs = (u, p, w, s, x, r)
    if on_cpu("cs_update", *vecs):
        return cs_update_torch(u, p, w, s, x, r, alpha, beta)
    n = u.shape[0]
    for v in vecs:
        if v.dtype != u.dtype or v.dim() != 1 or v.shape[0] != n \
                or not v.is_contiguous():
            raise ValueError(
                "cs_update: u, p, w, s, x, r must be contiguous 1-D vectors "
                f"of one dtype and length; got {[(tuple(t.shape), t.dtype) for t in vecs]}")
    if u.dtype not in DTYPE_SUFFIX or n == 0:
        raise TypeError(f"cs_update: no kernel for {u.dtype} of length {n}")
    al, be = (torch.as_tensor(v, device=u.device).to(torch.float32)
              for v in (alpha, beta))
    if al.numel() != 1 or be.numel() != 1:
        raise ValueError("cs_update: alpha and beta must be scalars")
    outs = [torch.empty_like(u) for _ in range(4)]
    ins = (ctypes.c_void_p * 6)(*(v.data_ptr() for v in vecs))
    ptrs = (ctypes.c_void_p * 4)(*(o.data_ptr() for o in outs))
    lib = _library()
    with torch.cuda.device(u.device):
        err = getattr(lib, f"sb_cs_update_{DTYPE_SUFFIX[u.dtype]}")(
            ins, ptrs, al.data_ptr(), be.data_ptr(), n,
            torch.cuda.current_stream(u.device).cuda_stream)
    _build.check(lib, err, "cs_update")
    cs_update.launches += 1
    return tuple(outs)


cs_update.launches = 0
