"""Future-discounted displacement loss (counterpart of
``routeformer_tpu/losses/future_discounted.py``).

Per-step weights ``gamma^t`` (t = 0 at the first predicted step), an
epsilon zone that zeroes errors with ``|err| < eps``, and mse, mae or
smooth-l1. Two behaviours of the reference are kept: the discount is
epoch-scheduled by a sticky ``{epoch: gamma}`` dict, and smooth-l1 ignores
epsilon (it is computed on the raw prediction and target).
"""

from typing import Dict, Optional, Union

import numpy as np
import torch

_LOSSES = ("mae", "mse", "smooth_l1")


def resolve_discount_factor(discount_factor: Union[float, Dict[int, float]],
                            epoch) -> float:
    """The value at the largest schedule key ``<= epoch`` (key 0 required)."""
    if isinstance(discount_factor, (float, int)):
        return float(np.float32(discount_factor))
    if 0 not in discount_factor:
        raise ValueError("Discount factor schedule must have a key for epoch 0.")
    gamma = discount_factor[0]
    for k in sorted(discount_factor):
        if epoch >= k:
            gamma = discount_factor[k]
    return float(np.float32(gamma))


def future_discounted_loss(y_pred: torch.Tensor, y_true: torch.Tensor, gamma: float,
                           epsilon: Optional[float] = None,
                           loss_function: str = "mse") -> torch.Tensor:
    """Mean of the discounted per-element error of ``(B, T, *)`` tensors."""
    if loss_function not in _LOSSES:
        raise ValueError(f"Unknown loss function {loss_function}")
    t = torch.arange(y_pred.shape[1], dtype=torch.float32, device=y_pred.device)
    # The base filled on the device: a copy from the host would wait for the stream.
    factors = torch.pow(torch.full((), gamma, dtype=torch.float32, device=y_pred.device), t)
    factors = factors.reshape((1, -1) + (1,) * (y_pred.ndim - 2))
    error = y_pred - y_true
    if epsilon is not None:
        error = torch.where(error.abs() < epsilon, torch.zeros_like(error), error)
    if loss_function == "mae":
        return (error.abs() * factors).mean()
    if loss_function == "mse":
        return (error.square() * factors).mean()
    diff = (y_pred - y_true).abs()  # smooth-l1 on the raw values, beta 1
    return (torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5) * factors).mean()


class FutureDiscountedLoss:
    """The loss with its schedule; the epoch is an argument of the call."""

    def __init__(self, discount_factor: Union[float, Dict[int, float]] = 0.9,
                 epsilon: Optional[float] = None, loss_function: str = "mse"):
        if loss_function not in _LOSSES:
            raise ValueError(f"Unknown loss function {loss_function}")
        if isinstance(discount_factor, dict) and 0 not in discount_factor:
            raise ValueError("Discount factor schedule must have a key for epoch 0.")
        self.discount_factor = discount_factor
        self.epsilon = epsilon
        self.loss_function = loss_function

    def __call__(self, y_pred, y_true, epoch=0):
        gamma = resolve_discount_factor(self.discount_factor, epoch)
        return future_discounted_loss(y_pred, y_true, gamma, self.epsilon,
                                      self.loss_function)
