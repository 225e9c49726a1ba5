"""Average and final displacement error (counterpart of
``routeformer_tpu/score/error.py``)."""

import torch


def ade(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean L2 distance over all points of ``(..., 2)`` trajectories."""
    assert pred.shape == target.shape, "trajectories must have the same shape"
    return torch.linalg.vector_norm(pred - target, dim=-1).mean()


def fde(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L2 distance between the final points of one ``(T, D)`` trajectory.

    The reference indexes ``[-1]`` on dim 0, so it is right only when called
    per sample, as its driver calls it; the JAX package keeps that contract
    (``docs/MIGRATION.md``), and so does this. ``fde_per_sample`` is the
    batched variant."""
    assert pred.shape == target.shape, "trajectories must have the same shape"
    return torch.linalg.vector_norm(pred[-1] - target[-1])


def ade_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``(B, T, D) -> (B,)`` mean L2 distance per sample."""
    assert pred.shape == target.shape, "trajectories must have the same shape"
    return torch.linalg.vector_norm(pred - target, dim=-1).mean(dim=-1)


def fde_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``(B, T, D) -> (B,)`` L2 distance of the final points."""
    assert pred.shape == target.shape, "trajectories must have the same shape"
    return torch.linalg.vector_norm(pred[:, -1] - target[:, -1], dim=-1)
