"""Solver-state checkpoint and resume (counterpart of
sparsebench_tpu/solvers/checkpoint.py; the reference has none).

CG runs in segments of ``checkpoint_every`` iterations; after each the
exact state (k, x, p, r, rtrans, normr, hist, done) goes to an ``.npz``
with the JAX package's keys, so a state either package saved resumes in
the other. The solve reads k, normr and done on the host at every segment
boundary and passes k to ``cg_run`` as the segment's start, so a segment
issues exactly ``k_end - k`` bodies; an inactive body changes no state,
so a segmented solve gives the bits of one run.

bf16 vectors are saved widened to f32 (numpy has no bf16) and narrowed
back on resume, which is exact.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from sparsebench_tpu_torch.config import synchronize
from sparsebench_tpu_torch.solvers.cg import (
    CGResult,
    cg_init,
    cg_run,
    default_acc_dtype,
)

_STATE_KEYS = ("k", "x", "p", "r", "rtrans", "normr", "hist", "done")


def save_state(path: str, state) -> None:
    """Write ``state`` to ``path`` atomically (a partial write never
    replaces a good checkpoint), creating its directory if need be."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for key, v in zip(_STATE_KEYS, state):
        v = torch.as_tensor(v).detach()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        arrays[key] = v.cpu().numpy()
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def load_state(path: str, vdt: torch.dtype, sdt: torch.dtype,
               device: torch.device):
    """The state saved at ``path`` as device tensors: x, p and r in the
    vectors' dtype ``vdt``, rtrans, normr and the history in the solver's
    scalar dtype ``sdt``, k int64 and done bool."""
    dtypes = {"k": torch.int64, "x": vdt, "p": vdt, "r": vdt, "rtrans": sdt,
              "normr": sdt, "hist": sdt, "done": torch.bool}
    with np.load(path) as z:
        return tuple(torch.from_numpy(np.array(z[key])).to(device, dtypes[key])
                     for key in _STATE_KEYS)


def solve_cg_checkpointed(A, b, *, checkpoint_path: str,
                          checkpoint_every: int = 50, itermax: int = 150,
                          eps: float = 0.0,
                          acc_dtype: Optional[torch.dtype] = None,
                          verbose: bool = True) -> CGResult:
    """Standard CG with a state snapshot every ``checkpoint_every``
    iterations; resumes from ``checkpoint_path`` where it exists (its
    history grows to ``itermax`` if shorter). ``b`` in original row
    order, as the returned x."""
    device = A.device
    b = torch.as_tensor(b, device=device)
    sdt = default_acc_dtype(b.dtype, acc_dtype)
    permuted = getattr(A, "permuted_output", False)
    b_in = A.permute_vector(b) if permuted else b

    if os.path.exists(checkpoint_path):
        state = load_state(checkpoint_path, b.dtype, sdt, device)
        hist = state[6]
        if hist.shape[0] < itermax:
            hist = torch.cat([hist, torch.full((itermax - hist.shape[0],),
                                               float("nan"), dtype=sdt,
                                               device=device)])
            state = state[:6] + (hist,) + state[7:]
        if verbose:
            print(f"Resuming from {checkpoint_path} at iteration "
                  f"{int(state[0])}")
    else:
        state = cg_init(A, b_in, torch.zeros_like(b_in), itermax, acc_dtype)

    eps_t = torch.tensor(eps, dtype=acc_dtype or b.dtype, device=device)
    t0 = time.perf_counter()
    while True:
        k, normr, done = int(state[0]), float(state[5]), bool(state[7])
        if k >= itermax or normr <= eps or done:
            break
        k_end = min(k + checkpoint_every, itermax)
        state = cg_run(A, state, k_end, eps_t, acc_dtype, k_start=k)
        synchronize(device)
        save_state(checkpoint_path, state)
        if verbose:
            print(f"checkpoint @ iteration {int(state[0])} "
                  f"residual {float(state[5]):E} -> {checkpoint_path}")
    t1 = time.perf_counter()

    k, x = int(state[0]), state[1]
    if permuted:
        x = A.unpermute_vector(x)
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    hist = state[6].cpu().numpy()
    return CGResult(
        x=x.cpu().numpy(),
        iterations=k,
        residual_history=hist[:k],
        final_normr=float(hist[k - 1] if k > 1 else hist[0]),
        solve_seconds=t1 - t0,
    )
