"""Runtime format registry (counterpart of
sparsebench_tpu/formats/registry.py)."""

from __future__ import annotations

from typing import Dict, Type

FORMATS: Dict[str, type] = {}


def register_format(name: str):
    def deco(cls):
        FORMATS[name] = cls
        cls.name = name
        return cls

    return deco


def get_format(name: str) -> Type:
    if name in FORMATS:
        return FORMATS[name]
    raise ValueError(
        f"unknown matrix format {name!r}; available: {sorted(FORMATS)}"
    )


def from_csr(name: str, csr, policy=None, **opts):
    """Build a device matrix of format ``name`` from the host CSR
    intermediate (the reference's ``convertMatrix``, src/matrix.h:56)."""
    return get_format(name).from_csr(csr, policy=policy, **opts)
