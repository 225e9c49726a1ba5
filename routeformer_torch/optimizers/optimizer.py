"""Grouped AdamW with global-norm clipping (counterpart of
``routeformer_tpu/optimizers/optimizer.py``, an optax chain there).

The update follows optax: the gradients are clipped to a global norm of
``gradient_clip_val``, then AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled
weight decay) with the rate ``schedule(count)`` for the ``count``-th update
(so a fresh optimizer's first update has rate 0 during warmup). Parameters
whose path contains ``video_backbone`` form their own group with its own
base rate. optax updates every parameter, so a parameter without a
gradient (the frozen backbone) is given a zero gradient: its weights still
decay, as in the JAX package. ``torch.optim.AdamW`` computes the same
update once every parameter has a gradient.

On a ``(data, model)`` mesh (``mesh`` set, ``parallel/mesh.py``) a
parameter may hold this rank's block of a sharded weight: AdamW steps the
blocks, and the clip's global norm is the norm of the whole gradient, each
sharded parameter's squares summed over the ranks that hold its distinct
blocks (``mesh.global_norm``), so every rank clips by the same factor.
"""

from typing import Optional

import torch
import torch.nn as nn

from routeformer_torch.optimizers.schedule import linear_warmup_cosine_annealing


class Optimizer:
    """``step()`` clips, updates and returns the pre-clip global grad norm."""

    def __init__(self, model: nn.Module, learning_rate: float, weight_decay: float,
                 video_backbone_lr: Optional[float], warmup_epochs: int,
                 max_epochs: int, steps_per_epoch: int,
                 gradient_clip_val: Optional[float]):
        groups = {"default": [], "video_backbone": []}
        for name, p in model.named_parameters():
            backbone = video_backbone_lr is not None and "video_backbone" in name
            groups["video_backbone" if backbone else "default"].append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.schedules, param_groups = [], []
        for key, base in (("default", learning_rate), ("video_backbone", video_backbone_lr)):
            if groups[key]:
                self.schedules.append(linear_warmup_cosine_annealing(
                    base, warmup_epochs, max_epochs, steps_per_epoch=steps_per_epoch))
                param_groups.append({"params": groups[key]})
        self.opt = torch.optim.AdamW(param_groups, lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=weight_decay,
                                     foreach=True)
        self.clip = gradient_clip_val
        self.count = 0  # updates applied, as optax's schedule count
        self.mesh = None  # the trainer's DeviceMesh, when its parameters are laid out on one

    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norms = torch._foreach_norm(grads)
        if self.mesh is None:
            norm = torch.linalg.vector_norm(torch.stack(norms))
        else:
            from routeformer_torch.parallel.mesh import global_norm

            norm = global_norm(self.params, norms, self.mesh)
        if self.clip is not None:
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            torch._foreach_mul_(grads, scale)
        for group, schedule in zip(self.opt.param_groups, self.schedules):
            group["lr"] = schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)


def build_optimizer(model: nn.Module, learning_rate: float = 1e-5,
                    weight_decay: float = 1e-4,
                    video_backbone_lr: Optional[float] = 1e-6,
                    warmup_epochs: int = 2, max_epochs: int = 200,
                    steps_per_epoch: int = 1,
                    gradient_clip_val: Optional[float] = 2.5) -> Optimizer:
    return Optimizer(model, learning_rate, weight_decay, video_backbone_lr,
                     warmup_epochs, max_epochs, steps_per_epoch, gradient_clip_val)
