"""Device matrix formats. Importing this package registers every ported
format (``dia`` and the matrix-free ``stencil``)."""

from sparsebench_tpu_torch.formats import dia, stencil  # noqa: F401  (register)
from sparsebench_tpu_torch.formats.registry import FORMATS, from_csr, get_format

__all__ = ["FORMATS", "from_csr", "get_format"]
