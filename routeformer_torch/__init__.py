"""PyTorch/CUDA port of routeformer_tpu for NVIDIA Hopper (H100).

The port imports torch, numpy and the standard library only, never jax,
flax or routeformer_tpu. Entry points (``build_flagship``,
``build_dinov2``, ``build_flagship_training``, ``load_serving_bundle``,
``synthetic_batch``) run on CUDA unless the caller passes
``device="cpu"``; when CUDA is asked for and absent they raise.
"""

from routeformer_torch.flagship import (
    build_dinov2,
    build_flagship,
    build_flagship_training,
    dinov2_config,
    flagship_config,
)
from routeformer_torch.io.synthetic import synthetic_batch
from routeformer_torch.serve import ServingModel, load_serving_bundle, save_serving_bundle

__all__ = [
    "ServingModel", "build_dinov2", "build_flagship", "build_flagship_training",
    "dinov2_config", "flagship_config", "load_serving_bundle", "save_serving_bundle",
    "synthetic_batch",
]
