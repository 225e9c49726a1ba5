"""Displacement metrics of the port."""

from routeformer_torch.score.error import ade, fde_per_sample

__all__ = ["ade", "fde_per_sample"]
