"""Solvers: standard CG (``cg``) and the SpMV bench (``profiled``)."""
