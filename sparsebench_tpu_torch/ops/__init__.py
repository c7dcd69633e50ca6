"""Kernels and their plain PyTorch versions. CUDA sources live in
``../csrc`` and are built by ``_build`` at first use."""
