"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into ONE shared library with a
plain C interface. The library is named after a hash of the sources and the
flags and lives under ``build/sparsebench_tpu_torch/`` at the repository
root, so a changed source rebuilds and an unchanged one loads at once. The
build runs at the first kernel launch; the compiler's output (``-Xptxas -v``
register and spill counts) is kept beside the library as ``<name>.log``.

No PyTorch headers are compiled: the wrappers pass tensor pointers and the
CUDA stream as integers (``ops/dia_spmv.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "sparsebench_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 900
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME/bin``, ``PATH`` or ``/usr/local/cuda/bin``."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(Path(cuda_home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise FileNotFoundError(
        "nvcc not found in $CUDA_HOME/bin, on PATH or in /usr/local/cuda/bin; "
        "the CUDA kernels of sparsebench_tpu_torch are built from csrc/ with nvcc"
    )


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsbtorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists;
    return its path. Raises when nvcc is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    out.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    return ctypes.CDLL(str(build()))
