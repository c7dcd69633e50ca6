"""Build the CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface, ``lib<name>_<hash>.so``; all the compilers that a build
needs are started together and then waited for. The hash covers the
flags, the source and the shared headers (``csrc/*.cuh``), and the
libraries live under ``build/sparsebench_tpu_torch/`` at the repository
root, so a changed source rebuilds and an unchanged one loads at once. The
build runs at the first kernel launch (or up front, ``build()``); the
compiler's output (``-Xptxas -v`` register and spill counts) is kept beside
each library as ``<name>.log``.

No PyTorch headers are compiled: the wrappers pass tensor pointers and the
CUDA stream as integers (``ops/dia_spmv.py``). Every library exports
``sb_cuda_error_string`` (``csrc/common.cuh``), which ``check`` uses to name
a launch error.

Each library loaded in the process is kept in ``LOADS`` (its name, whether
nvcc ran, the seconds of its build and load); while the program's recorder
records, the load is also a span ``load_library`` and a build counts
``libraries_built`` (``profiler.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple, Optional

from sparsebench_tpu_torch import profiler

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


def library_path(src: Path) -> Path:
    """Where the library of ``src`` is built: named after its stem and a
    hash of the flags, the shared headers and the source."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [*sorted(CSRC_DIR.glob("*.cuh")), src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the libraries of ``names`` (source stems; default all) that
    are not built yet, one nvcc each, all at once; return {name: path}.
    Raises when nvcc is missing or any compile fails."""
    srcs = {s.stem: s for s in sources()}
    if names is not None:
        srcs = {n: srcs[n] for n in names}
    out = {n: library_path(s) for n, s in srcs.items()}
    todo = [n for n, p in out.items() if not p.exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].parent / f"{out[n].name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs[n] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for n, (tmp, cmd, proc) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
            stderr += f"\nnvcc killed after {NVCC_TIMEOUT_S} s"
        out[n].with_suffix(".log").write_text(
            " ".join(cmd) + "\n" + stdout + stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{srcs[n].name} (exit {proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, out[n])  # atomic: a loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed on " + "\n".join(failed))
    return out


class Load(NamedTuple):
    """A library's load: ``built`` when nvcc ran for it."""
    library: str
    built: bool
    seconds: float


LOADS: list = []  # every Load of this process, in order


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The kernel library built from ``csrc/<name>.cu``, built on first
    use."""
    t0 = time.perf_counter()
    with profiler.span("load_library", library=name) as s:
        src = CSRC_DIR / f"{name}.cu"
        built = src.is_file() and not library_path(src).exists()
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.sb_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sb_cuda_error_string.restype = ctypes.c_char_p
        s.set(built=built)
        if built:
            profiler.count("libraries_built")
    LOADS.append(Load(name, built, time.perf_counter() - t0))
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a refused launch
    never runs, and a later synchronise would not report it)."""
    if err != 0:
        raise RuntimeError(
            f"{what}: kernel launch failed: CUDA error {err} "
            f"({lib.sb_cuda_error_string(err).decode()})"
        )
