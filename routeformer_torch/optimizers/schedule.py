"""Linear warmup then cosine annealing (counterpart of
``routeformer_tpu/optimizers/schedule.py``), in float32 as there.

``epoch = floor(step / steps_per_epoch)``; below ``warmup_epochs`` the rate
rises linearly with the reference's ``warmup_epochs - 1`` denominator (it
reaches the base rate one epoch before warmup ends), then follows the cosine.
"""

import numpy as np


def linear_warmup_cosine_annealing(base_lr: float, warmup_epochs: int,
                                   max_epochs: int, warmup_start_lr: float = 0.0,
                                   eta_min: float = 0.0, steps_per_epoch: int = 1):
    """``step -> lr`` (a Python float computed in float32)."""
    f = np.float32

    def schedule(step) -> float:
        epoch = np.floor(f(step) / f(steps_per_epoch))
        warmup = f(warmup_start_lr) + epoch * (f(base_lr) - f(warmup_start_lr)) / f(
            max(1, warmup_epochs - 1))
        progress = (epoch - f(warmup_epochs)) / f(max(1, max_epochs - warmup_epochs))
        cosine = f(eta_min) + f(0.5) * (f(base_lr) - f(eta_min)) * (
            f(1.0) + np.cos(f(np.pi) * progress))
        return float(warmup if epoch < warmup_epochs else cosine)

    return schedule
