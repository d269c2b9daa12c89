"""Kernels (CUDA C++ in ../csrc) with their plain PyTorch versions, and the quantized-linear dispatch."""
