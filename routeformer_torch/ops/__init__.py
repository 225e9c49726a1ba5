"""Tensor functions and the hand-written CUDA kernels of the port (K1, K2,
K3a/K3b, K4).

Kernel modules import nothing CUDA-specific at import time; the kernels
are built from ``routeformer_torch/csrc`` at their first launch.
"""
