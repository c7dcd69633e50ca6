"""Pass 1 of the compact row-block CSR SpMV: the hand-written CUDA kernel P5
and its plain PyTorch version (counterpart of
benchmarks/csr_twopass_proto.py ``pass1_products``).

The kernel is ``csrc/csr_twopass.cu``; its source note says what bounds it.
One matrix's streams (benchmarks/csr_twopass_proto.py ``build_streams``):

    val     (nb, block_cap / 128, 128) f32     stored values, 0 in padding
    colrel  (nb, block_cap / 128, 128) int32   column - (b R - band)

and ``xpad`` = [band zeros, x, R + band zeros]. The products are

    out[b, e] = val[b, e] * xpad[b R + colrel[b, e]]

with 0 in place of the x value where colrel leaves the block's window
[0, R + 2 band), as the TPU kernel's select chain gives.

* ``pass1_products_torch(val, colrel, xpad, band, rows_per_block)`` — the
  plain version, one gather and one product: the kernel's bit-exact
  reference.
* ``pass1_products(val, colrel, xpad, band, rows_per_block)`` — the wrapper:
  the plain version for CPU tensors, the kernel for CUDA tensors (or a
  ValueError). ``pass1_products.launches`` counts kernel launches.

The row sums that follow (pass 2) are plain torch in the benchmark, as they
are plain XLA in the JAX prototype.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sparsebench_tpu_torch.ops import _build

LANES = 128


def _window(band: int, rows_per_block: int) -> int:
    """Floats in a block's window of x: R + 2 band, whole lane rows."""
    window = rows_per_block + 2 * band
    if band < 0 or rows_per_block <= 0 or window % LANES:
        raise ValueError(
            f"pass1_products: rows_per_block + 2*band = {window} must be a "
            f"positive multiple of {LANES} (rows_per_block={rows_per_block}, "
            f"band={band})")
    return window


def _check(val: torch.Tensor, colrel: torch.Tensor, xpad: torch.Tensor,
           band: int, rows_per_block: int) -> int:
    window = _window(band, rows_per_block)
    if (val.dim() != 3 or val.shape[2] != LANES or val.dtype != torch.float32
            or tuple(colrel.shape) != tuple(val.shape)
            or colrel.dtype != torch.int32):
        raise ValueError(
            f"pass1_products: val must be f32 (nb, cap/{LANES}, {LANES}) and "
            f"colrel int32 of the same shape; got {val.dtype} "
            f"{tuple(val.shape)} and {colrel.dtype} {tuple(colrel.shape)}")
    nb = val.shape[0]
    need = (nb - 1) * rows_per_block + window
    if xpad.dim() != 1 or xpad.dtype != torch.float32 or xpad.numel() < need:
        raise ValueError(
            f"pass1_products: xpad must be f32 1-D with at least (nb-1)*R + "
            f"R + 2*band = {need} entries; got {xpad.dtype} "
            f"{tuple(xpad.shape)}")
    return window


def pass1_products_torch(val: torch.Tensor, colrel: torch.Tensor,
                         xpad: torch.Tensor, band: int,
                         rows_per_block: int) -> torch.Tensor:
    """Plain version: (nb, cap/128, 128) products in val's shape."""
    window = _check(val, colrel, xpad, band, rows_per_block)
    nb = val.shape[0]
    base = (torch.arange(nb, device=val.device, dtype=torch.int64)
            * rows_per_block).view(nb, 1, 1)
    c = colrel.long()
    inside = (c >= 0) & (c < window)
    g = xpad[torch.where(inside, base + c, base)]
    g = torch.where(inside, g, torch.zeros((), dtype=g.dtype, device=g.device))
    return val * g


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("csr_twopass")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # val, colrel, xpad, out, nb, block_cap, rows_per_block, window,
    # xpad_len, stream
    lib.sb_csr_pass1_f32.argtypes = [p, p, p, p, i64, i32, i32, i32, i64, p]
    lib.sb_csr_pass1_f32.restype = i32
    return lib


def pass1_products(val: torch.Tensor, colrel: torch.Tensor,
                   xpad: torch.Tensor, band: int,
                   rows_per_block: int) -> torch.Tensor:
    """(nb, cap/128, 128) products: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (module docstring)."""
    tensors = (val, colrel, xpad)
    if all(t.device.type == "cpu" for t in tensors):
        return pass1_products_torch(val, colrel, xpad, band, rows_per_block)
    dev = xpad.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "pass1_products: the kernel runs on one CUDA device and got "
            f"tensors on {sorted({str(t.device) for t in tensors})}")
    window = _check(val, colrel, xpad, band, rows_per_block)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("pass1_products: val, colrel and xpad must be "
                         "contiguous")
    nb, capl, _ = val.shape
    lib = _library()
    out = torch.empty_like(val)
    with torch.cuda.device(dev):
        err = lib.sb_csr_pass1_f32(
            val.data_ptr(), colrel.data_ptr(), xpad.data_ptr(),
            out.data_ptr(), nb, capl * LANES, rows_per_block, window,
            xpad.numel(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "pass1_products")
    pass1_products.launches += 1
    return out


pass1_products.launches = 0
