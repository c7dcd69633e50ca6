"""Device matrix formats. Importing this package registers every format:
``dia``, the matrix-free ``stencil``, ``bslab``, ``bsell``, ``sell``,
``ell``, ``crs`` and ``ccrs``."""

from sparsebench_tpu_torch.formats import (  # noqa: F401  (register)
    bsell,
    bslab,
    crs,
    dia,
    sell,
    stencil,
)
from sparsebench_tpu_torch.formats.registry import FORMATS, from_csr, get_format

__all__ = ["FORMATS", "from_csr", "get_format"]
