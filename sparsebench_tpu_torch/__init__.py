"""sparsebench_tpu_torch — the PyTorch and CUDA port of sparsebench_tpu.

The JAX package ``sparsebench_tpu`` stays the reference; this package runs
the same benchmark on an NVIDIA GPU (Hopper, ``sm_90a``) with PyTorch for
the plain tensor code and hand-written CUDA C++ kernels (``csrc/``) where the
JAX package wrote Pallas kernels. Module names mirror the JAX package so each
counterpart is easy to find.

Ported so far: the default CG/SpMV path — the generated 27/7-point stencil
built straight into DIA storage (``formats/dia.py``), the DIA SpMV kernel
(``ops/dia_spmv.py`` + ``csrc/dia_spmv.cu``), standard CG
(``solvers/cg.py``), the SpMV bench (``solvers/profiled.py``), the region
profiler and the CLI (``python -m sparsebench_tpu_torch -t cg``); and the
matrix-free stencil slice (``--fmt stencil``): the operator
(``formats/stencil.py``), its apply kernels (``ops/stencil.py`` +
``csrc/stencil.cu``), the CG variants ``cs``, ``fused`` and ``vmem`` with
the fused update (``ops/cg_fused.py`` + ``csrc/cg_fused.cu``) and the
whole-solve kernel (``ops/stencil_cg_vmem.py`` +
``csrc/stencil_cg_vmem.cu``); and the general formats: bslab
(``formats/bslab.py``) with its SpMV kernels K6 and K7 (``ops/bslab_spmv.py``
+ ``csrc/bslab_spmv.cu``), the RGL matrix built on the device in bslab
layout (``formats/rgl_build.py``), SELL-C-sigma and ELLPACK
(``formats/sell.py``, ``formats/scs_host.py``), CRS and CCRS
(``formats/crs.py``) with their SpMV kernel K14 (``ops/crs_spmv.py`` +
``csrc/crs_spmv.cu``), and the RCM reordering (``host.py``).

The package imports ``torch`` and nothing of JAX or of the JAX package:
importing ``sparsebench_tpu`` would run its allocator set-up in the
process being measured. The host ingest (``host.py``) and the
parameter-file reader (``config.py``) are numpy copies of the JAX
package's, held to them by the tests.
"""

from sparsebench_tpu_torch.version import __version__

__all__ = ["__version__"]
