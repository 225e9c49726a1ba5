"""Displacement metrics and the Path Complexity Index of the port."""

from routeformer_torch.score.error import ade, ade_per_sample, fde, fde_per_sample
from routeformer_torch.score.frechet import frechet_distance, frechet_distance_batch
from routeformer_torch.score.pci import (
    estimate_pci,
    estimate_pci_batch,
    estimate_regular_trajectory,
    pci,
)

__all__ = ["ade", "ade_per_sample", "estimate_pci", "estimate_pci_batch", "estimate_regular_trajectory",
           "fde", "fde_per_sample", "frechet_distance", "frechet_distance_batch", "pci"]
