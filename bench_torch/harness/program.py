"""The system under test, reached only through these entries of the
PyTorch port (``sparsebench_tpu_torch``):

* ``formats.registry.get_format(cfg["format"]).from_stencil``: the
  matrix built on the device (DIA: ``formats/dia.py``, the layout that
  the CLI's ``--fmt auto`` picks for a generated stencil);
* ``A.spmv``: one SpMV, as ``-t spmv`` times it (DIA: K1), called by
  ``harness/traffic.py``;
* ``solvers.cg.resolve_cg_loop(variant)``: the masked loop that
  ``solve_cg`` times, called directly, without ``solve_cg``'s warm-up
  solve and copies to the host;
* ``solvers.cg_multi.cg_multi_loop``: the loop that ``solve_cg_multi``
  times (DIA: K8 through ``A.spmm_kn``).

The port's kernels build into its own cache, ``build/sparsebench_tpu_torch/``
inside the checkout, on first use.
"""

from __future__ import annotations

import torch

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32, "f64": torch.float64}


def build_matrix(cfg: dict, vectors: str, device: torch.device):
    """The configuration's operator, built on ``device`` for vectors of
    dtype ``vectors``, the policy under which the port stores its values
    (f32: bf16 diagonals, exact for the stencil's values)."""
    from sparsebench_tpu_torch.config import DTypePolicy
    from sparsebench_tpu_torch.formats.registry import get_format

    policy = DTypePolicy.from_names(vectors)
    A, _counts = get_format(cfg["format"]).from_stencil(
        cfg["nx"], cfg["ny"], cfg["nz"], device=device, policy=policy,
        use_7pt=cfg["stencil_points"] == 7)
    return A


def cg_loop(variant: str):
    from sparsebench_tpu_torch.solvers.cg import resolve_cg_loop

    return resolve_cg_loop(variant)


def cg_multi_loop():
    from sparsebench_tpu_torch.solvers.cg_multi import cg_multi_loop as loop

    return loop
