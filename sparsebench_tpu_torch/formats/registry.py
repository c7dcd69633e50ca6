"""Runtime format registry (counterpart of sparsebench_tpu/formats/registry.py).

``dia`` and the matrix-free ``stencil`` are ported. Every other format
name of the JAX package raises and names the ROADMAP.md item that ports
it, so a request for an unported format never falls through to another
one.
"""

from __future__ import annotations

from typing import Dict, Type

FORMATS: Dict[str, type] = {}

NOT_PORTED = {
    "bslab": "Queue 1 item 7",
    "sell": "Queue 1 item 7",
    "crs": "Queue 1 item 7",
    "ccrs": "Queue 1 item 7",
    "ell": "Queue 1 item 7",
    "bsell": "Queue 1 item 10",
}


def register_format(name: str):
    def deco(cls):
        FORMATS[name] = cls
        cls.name = name
        return cls

    return deco


def get_format(name: str) -> Type:
    if name in FORMATS:
        return FORMATS[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"matrix format {name!r} is not ported to sparsebench_tpu_torch "
            f"yet (ROADMAP.md {NOT_PORTED[name]}); available: {sorted(FORMATS)}"
        )
    raise ValueError(
        f"unknown matrix format {name!r}; available: {sorted(FORMATS)}"
    )


def from_csr(name: str, csr, policy=None, **opts):
    """Build a device matrix of format ``name`` from the host CSR
    intermediate (the reference's ``convertMatrix``, src/matrix.h:56)."""
    return get_format(name).from_csr(csr, policy=policy, **opts)
