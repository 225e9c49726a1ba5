"""One training step and one eval step (counterparts of
``routeformer_tpu/parallel/train_step.py::make_train_step`` and
``make_eval_step``): forward, loss, backward, clip and AdamW; the
eval-mode forward. With ``mesh=`` (``parallel/mesh.py``) the model's
parameters are laid out by the structural rule (``min_shard_dim``,
``fsdp``), each rank steps on its row block of the batch, and the
gradients are the data shards' mean, as GSPMD's psum makes them."""

import contextlib
from typing import Callable

import torch
import torch.nn as nn

from routeformer_torch.optimizers.optimizer import Optimizer
from routeformer_torch.parallel import mesh as meshlib
from routeformer_torch.parallel.mesh import DATA_AXIS  # noqa: F401  (re-exported as in the JAX module)
from routeformer_torch.utils import profiling


def _layout(model: nn.Module, mesh, min_shard_dim: int, fsdp: bool):
    """The model's ``MeshParams`` on ``mesh``, made once (a model laid out
    by an earlier step keeps its layout)."""
    meshlib.check_mesh(mesh)
    layout = getattr(model, "_mesh_params", None)
    if layout is None or layout.mesh is not mesh:
        layout = meshlib.MeshParams(model, mesh, min_shard_dim, fsdp)
        model._mesh_params = layout
        meshlib.share_streams([model], mesh, next(model.parameters()).device)
    return layout


def make_train_step(model: nn.Module, optimizer: Optimizer, loss_fn: Callable, mesh=None,
                    min_shard_dim: int = 512, fsdp: bool = False):
    """``step(input_batch, target_batch, epoch) -> metrics``.

    ``loss_fn(model, input_batch, target_batch, epoch) -> (loss, metrics)``.
    The metrics are detached tensors: the loss function's, ``total_loss``
    and ``grad_norm`` (the global norm before clipping). The model is put
    in training mode. On a mesh the batches' numpy leaves are global (this
    rank takes its row block) and tensors are this rank's rows; the
    metrics are the global batch's."""
    model.train()
    layout = None
    if mesh is not None:
        layout = _layout(model, mesh, min_shard_dim, fsdp)
        optimizer.mesh = mesh

    def train_step(input_batch: dict, target_batch: dict, epoch) -> dict:
        optimizer.zero_grad()
        if layout is None:
            with profiling.span("rf.loss"):
                loss, metrics = loss_fn(model, input_batch, target_batch, epoch)
            with profiling.span("rf.backward"):
                loss.backward()
        else:
            device = next(model.parameters()).device
            input_batch = meshlib.shard_batch(input_batch, mesh, device)
            target_batch = meshlib.shard_batch(target_batch, mesh, device)
            with layout.gathered():  # the data reductions run under the backward
                with profiling.span("rf.loss"):
                    loss, metrics = loss_fn(model, input_batch, target_batch, epoch)
                with profiling.span("rf.backward"):
                    loss.backward()
                    layout.reduce_grads()
        metrics = dict(metrics)
        metrics["total_loss"] = loss.detach()
        if layout is not None:
            metrics = meshlib.mean_over_data(metrics, mesh)
        with profiling.span("rf.optimizer"):
            metrics["grad_norm"] = optimizer.step().detach()
        return metrics

    def step(input_batch: dict, target_batch: dict, epoch) -> dict:
        # The root span closes after ``train_step``'s locals are gone: freeing
        # the step's autograd graph takes milliseconds of host time.
        with profiling.span("rf.train_step"):
            return train_step(input_batch, target_batch, epoch)

    return step


def make_eval_step(model: nn.Module, eval_fn: Callable, mesh=None, min_shard_dim: int = 512,
                   fsdp: bool = False) -> Callable:
    """``step(*args) -> eval_fn(model, *args)`` with the model in eval mode,
    under ``torch.inference_mode``. On a mesh the model's weights are
    gathered one unit at a time while the call runs (``MeshParams.gathered``;
    every rank calls the step together) and ``eval_fn`` gets the arguments
    as given."""
    layout = None if mesh is None else _layout(model, mesh, min_shard_dim, fsdp)
    model.eval()

    def step(*args):
        gathered = contextlib.nullcontext() if layout is None else layout.gathered()
        with torch.inference_mode(), gathered:
            return eval_fn(model, *args)

    return step
