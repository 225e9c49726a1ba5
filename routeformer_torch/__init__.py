"""PyTorch/CUDA port of routeformer_tpu for NVIDIA Hopper (H100).

The port imports torch, numpy, scipy and the standard library only, never
jax, flax or routeformer_tpu. Entry points run on CUDA unless the caller
passes ``device="cpu"``; when CUDA is asked for and absent they raise:

- models and steps: ``build_flagship``, ``build_dinov2``,
  ``build_flagship_training``, ``load_serving_bundle``; ``export_model``
  and ``ExportedModel`` (a ``torch.export`` serving artifact over the
  kernels' registered ops);
- data: ``synthetic_batch`` (tensors on a device), ``SyntheticDataset``
  (numpy batches, no device), ``GEMDataset`` and ``DreyeveDataset``;
- training: ``ParallelTrainer`` (lockstep multi-model trainer with the
  Monte-Carlo, PCI-bucketed eval), ``CheckpointManager`` (best-ADE
  checkpoints and the latest snapshot for exact resume), and the driver,
  ``python -m routeformer_torch.experiments.full_comparison``
  (``full_comparison.main``; ``ROUTEFORMER_FORCE_CPU=1`` runs it on the
  CPU).
"""

from routeformer_torch.experiments import full_comparison
from routeformer_torch.flagship import (
    build_dinov2,
    build_flagship,
    build_flagship_training,
    dinov2_config,
    flagship_config,
)
from routeformer_torch.io.synthetic import SyntheticDataset, synthetic_batch
from routeformer_torch.serve import (
    ExportedModel,
    ServingModel,
    export_model,
    load_serving_bundle,
    save_serving_bundle,
)
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.train import CheckpointManager, ParallelTrainer
from routeformer_torch.utils.logging import set_logger_config


def __getattr__(name):
    # the datasets are imported on first use: they pull in scipy and the readers
    if name in ("GEMDataset", "DreyeveDataset"):
        from routeformer_torch import io

        return getattr(io, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CheckpointManager", "DreyeveDataset", "ExportedModel", "GEMDataset", "ParallelTrainer",
    "Routeformer", "RouteformerConfig", "ServingModel", "SyntheticDataset", "build_dinov2",
    "build_flagship", "build_flagship_training", "dinov2_config", "export_model",
    "flagship_config", "full_comparison", "load_serving_bundle", "save_serving_bundle",
    "set_logger_config", "synthetic_batch",
]
