"""One training step and one eval step on one device (counterparts of
``routeformer_tpu/parallel/train_step.py::make_train_step`` and
``make_eval_step`` with ``mesh=None``): forward, loss, backward, clip and
AdamW; the eval-mode forward."""

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


def make_eval_step(model: nn.Module, eval_fn: Callable, mesh=None) -> Callable:
    """``step(*args) -> eval_fn(model, *args)`` with the model in eval mode,
    under ``torch.inference_mode``. ``mesh=`` (several cards) is not
    ported."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (data and tensor parallelism over several cards) is not "
            "ported: ROADMAP.md §1 item 2")
    model.eval()

    def step(*args):
        with torch.inference_mode():
            return eval_fn(model, *args)

    return step
