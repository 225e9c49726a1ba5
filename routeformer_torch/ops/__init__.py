"""Tensor functions and the hand-written CUDA kernels (K1, K2) of the port.

Kernel modules import nothing CUDA-specific at import time; the kernels
are built from ``routeformer_torch/csrc`` at their first launch.
"""
