"""Solvers: CG and its variants ``cs``, ``fused`` and ``vmem`` (``cg``) and
the SpMV bench (``profiled``)."""
