"""One training step on one device (counterpart of
``routeformer_tpu/parallel/train_step.py::make_train_step`` with
``mesh=None``): forward, loss, backward, clip and AdamW."""

from typing import Callable

import torch
import torch.nn as nn

from routeformer_torch.optimizers.optimizer import Optimizer


def make_train_step(model: nn.Module, optimizer: Optimizer, loss_fn: Callable):
    """``step(input_batch, target_batch, epoch) -> metrics``.

    ``loss_fn(model, input_batch, target_batch, epoch) -> (loss, metrics)``.
    The metrics are detached tensors: the loss function's, ``total_loss``
    and ``grad_norm`` (the global norm before clipping). The model is put
    in training mode."""
    model.train()

    def step(input_batch: dict, target_batch: dict, epoch) -> dict:
        optimizer.zero_grad()
        loss, metrics = loss_fn(model, input_batch, target_batch, epoch)
        loss.backward()
        metrics = dict(metrics)
        metrics["total_loss"] = loss.detach()
        metrics["grad_norm"] = optimizer.step().detach()
        return metrics

    return step
