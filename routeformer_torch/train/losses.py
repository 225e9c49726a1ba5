"""Routeformer training loss (counterpart of
``routeformer_tpu/train/losses.py``): future-discounted smooth-l1 on the
GPS, and with ``dense_prediction`` the same loss on the predicted against
the detached target visual features, weighted by the detached
``ratio * traj / max(dense, 1e-6)`` from epoch 10 on (0 before). An
autoregressive model with dense prediction is trained on its first
``autoregressive_step_size`` steps: both losses on those steps, the
trajectory loss scaled by ``pred_len / step``. On a mesh with several data
shards the weight is built from the global batch's two losses."""

from dataclasses import dataclass
from typing import Optional

import torch

from routeformer_torch.losses import FutureDiscountedLoss
from routeformer_torch.score.error import ade, fde_per_sample


@dataclass
class TrainingLosses:
    trajectory_loss: FutureDiscountedLoss
    dense_loss: FutureDiscountedLoss

    @classmethod
    def from_config(cls, config) -> "TrainingLosses":
        return cls(
            trajectory_loss=FutureDiscountedLoss(config.discount_factor, config.epsilon,
                                                 loss_function="smooth_l1"),
            dense_loss=FutureDiscountedLoss(config.discount_factor,
                                            config.visual_epsilon,
                                            loss_function="smooth_l1"),
        )


def routeformer_training_loss(model, input_batch: dict, target_batch: dict, epoch,
                              losses: Optional[TrainingLosses] = None):
    """``(total_loss, metrics)`` of one model on one batch.

    The target pass runs without autograd but with the model still in
    training mode, so its Perceive stacks drop out and sample keys as the
    JAX package's does."""
    cfg = model.configs
    losses = losses or TrainingLosses.from_config(cfg)
    target_gps = target_batch["gps"].float()
    metrics = {}
    if cfg.dense_prediction:
        future_gps, future_visual = model(input_batch)
        with torch.no_grad():
            _, target_visual = model.preprocess_batch(target_batch, training=False)
        target_visual = target_visual[:, : future_visual.shape[1]]
        if cfg.autoregressive:
            step = cfg.autoregressive_step_size
            future_gps, target_gps = future_gps[:, :step], target_gps[:, :step]
            future_visual, target_visual = future_visual[:, :step], target_visual[:, :step]
        traj = losses.trajectory_loss(future_gps, target_gps, epoch)
        if cfg.autoregressive:
            traj = traj * (cfg.gps_backbone_config.pred_len / step)
        dense = losses.dense_loss(future_visual, target_visual, epoch)
        traj_all, dense_all = _global_means(model, traj.detach(), dense.detach())
        weight = cfg.dense_loss_ratio * traj_all / torch.clamp(dense_all, min=1e-6)
        if epoch < 10:
            weight = torch.zeros_like(weight)
        metrics["dense_loss"] = dense.detach()
        total = traj + weight * dense
    else:
        future_gps = model(input_batch)
        traj = losses.trajectory_loss(future_gps, target_gps, epoch)
        total = traj
    metrics["loss"] = traj.detach()
    metrics["ade"] = ade(future_gps, target_gps).detach()
    metrics["fde"] = fde_per_sample(future_gps, target_gps).mean().detach()
    return total, metrics


def _global_means(model, *values):
    """The global batch's means of per-shard means: averaged over the data
    shards when ``model.data_group`` is set (a mesh with several), so a
    weight built from them is the one JAX builds from the global batch."""
    group = getattr(model, "data_group", None)
    if group is None:
        return values
    import torch.distributed as dist

    stacked = torch.stack(values)
    dist.all_reduce(stacked, group=group)
    return (stacked / dist.get_world_size(group)).unbind()
