"""Tensor functions and the hand-written CUDA kernels of the port (K1, K2,
K3a/K3b, K4).

Kernel modules import nothing CUDA-specific at import time; the kernels
are built from ``routeformer_torch/csrc`` at their first launch.
"""

from routeformer_torch.ops.attention import (
    autocorrelation_attention,
    dot_product_attention,
    prob_sparse_attention,
)
from routeformer_torch.ops.fusion_stack import (
    StackWeights,
    fused_perceive_stack,
    make_dropout_masks,
    sample_count_matrices,
    stack_reference,
)
from routeformer_torch.ops.heatmap import overlay_heatmap_on_frame, rasterize_gaze_heatmap
from routeformer_torch.ops.image import (
    crop_horizontal,
    remap,
    resize_video,
    to_float16,
    undistort_video,
)

__all__ = [
    "StackWeights", "autocorrelation_attention", "crop_horizontal", "dot_product_attention",
    "fused_perceive_stack", "make_dropout_masks", "overlay_heatmap_on_frame",
    "prob_sparse_attention", "rasterize_gaze_heatmap", "remap", "resize_video",
    "sample_count_matrices", "stack_reference", "to_float16", "undistort_video",
]
