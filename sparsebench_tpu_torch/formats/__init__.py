"""Device matrix formats. Importing this package registers every ported
format (only ``dia`` so far)."""

from sparsebench_tpu_torch.formats import dia  # noqa: F401  (registers "dia")
from sparsebench_tpu_torch.formats.registry import FORMATS, from_csr, get_format

__all__ = ["FORMATS", "from_csr", "get_format"]
