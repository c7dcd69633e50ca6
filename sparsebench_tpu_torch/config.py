"""Runtime configuration: parameters, .par files, dtype policy, device.

Counterpart of sparsebench_tpu/config.py. ``Parameter`` holds the
reference's fields (src/parameter.h:8-13, defaults src/parameter.c:12-20)
and the runtime keys the port reads; ``read_parameter`` parses the same
``key value  # comment`` files, ignoring unknown keys. ``DTypePolicy`` has
the JAX one's names (f64 | f32 | bf16, i32 | i64), resolved to torch dtypes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "DTypePolicy",
    "Parameter",
    "print_parameter",
    "read_parameter",
    "resolve_device",
    "synchronize",
]

@dataclasses.dataclass
class Parameter:
    """Benchmark parameters. f32 is the default value dtype, as in the JAX
    package (the reference's is double, config.mk:7); ``--dtype f64`` gives
    the reference's precision."""

    filename: str = "generate"  # generate | generate7P | a .mtx/.bmx path
    nx: int = 100
    ny: int = 100
    nz: int = 100
    itermax: int = 150
    eps: float = 0.0
    fmt: str = "auto"
    dtype: str = "f32"
    index_dtype: str = "i32"
    chunk_height: int = 0  # SELL C; 0 = the format's default
    sigma: int = 0         # SELL sorting scope; 0 = the format's default
    shards: int = 1
    # generateRGL, the irregular random-graph Laplacian (host.py rgl_csr)
    band: int = 512        # half-bandwidth of the random graph
    deg: float = 16.0      # target average degree
    seed: int = 1          # graph seed
    bench: str = "cg"


_INT_KEYS = {"nx", "ny", "nz", "itermax", "chunk_height", "sigma", "shards",
             "band", "seed"}
_REAL_KEYS = {"eps", "deg"}
_STR_KEYS = {"filename", "fmt", "dtype", "index_dtype", "bench"}


def read_parameter(param: Parameter, filename: str) -> Parameter:
    """Parse a .par file into ``param`` (reference src/parameter.c:22-62):
    one ``key value`` pair per line, ``#`` starts a comment, unknown keys
    are ignored."""
    with open(filename, "r") as fp:
        for line in fp:
            toks = line.split("#", 1)[0].split()
            if len(toks) < 2:
                continue
            key, val = toks[0], toks[1]
            if key in _INT_KEYS:
                setattr(param, key, int(val))
            elif key in _REAL_KEYS:
                setattr(param, key, float(val))
            elif key in _STR_KEYS:
                setattr(param, key, val)
    return param


def print_parameter(param: Parameter) -> str:
    """The reference's printParameter text (src/parameter.c:66-73)."""
    return "\n".join([
        "Parameters",
        "Iterative solver parameters:",
        f"\tMax iterations: {param.itermax}",
        f"\tepsilon (stopping tolerance) : {param.eps:f}",
    ])


_VALUE = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}
_INDEX = {"i32": torch.int32, "i64": torch.int64}


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Value/index dtype selection (reference src/util.h:35-53, runtime
    here). ``value`` is the CG_FLOAT analog, ``index`` the CG_UINT analog;
    the index width only enters the reference's byte model (DIA stores no
    indices)."""

    value: torch.dtype
    index: torch.dtype

    @staticmethod
    def from_names(value: str = "f64", index: str = "i32") -> "DTypePolicy":
        if value not in _VALUE:
            raise ValueError(f"unknown value dtype {value!r}")
        if index not in _INDEX:
            raise ValueError(f"unknown index dtype {index!r}")
        return DTypePolicy(value=_VALUE[value], index=_INDEX[index])

    @property
    def value_bytes(self) -> int:
        return self.value.itemsize

    @property
    def index_bytes(self) -> int:
        return self.index.itemsize

    @property
    def host_value(self) -> np.dtype:
        """numpy dtype for host-side vectors: numpy has no bf16, so bf16
        vectors are built in f32 (exact for the benchmark's b and x) and
        narrowed on the device."""
        return np.dtype(np.float64 if self.value == torch.float64
                        else np.float32)


def resolve_device(name: str) -> torch.device:
    """``torch.device`` for ``name`` ("cuda", "cuda:N" or "cpu"). Asking for
    CUDA where there is none raises: a run never drops to the CPU
    silently."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu to run the plain PyTorch path"
            )
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; use cuda or cpu")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU, which runs
    eagerly): a host clock around device work ends here."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
