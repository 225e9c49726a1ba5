"""Optimizer and learning-rate schedule of the port."""

from routeformer_torch.optimizers.optimizer import Optimizer, build_optimizer
from routeformer_torch.optimizers.schedule import linear_warmup_cosine_annealing

__all__ = ["Optimizer", "build_optimizer", "linear_warmup_cosine_annealing"]
