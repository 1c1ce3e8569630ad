"""Kernels: hand-written CUDA sources (csrc/), their wrappers and plain versions."""
