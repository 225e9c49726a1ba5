"""Trivial GPS forecasting baselines (counterpart of
``routeformer_tpu/models/gps_backbone/baselines.py``): zero velocity
("stationary") and the mean of the last 5 velocities ("linear") over
velocity inputs. Neither has parameters."""

import torch
import torch.nn as nn

from routeformer_torch.models.gps_backbone.config import GPSBackboneConfig


class StationaryBaseline(nn.Module):
    """Predicts zero velocity for every future step."""

    def __init__(self, configs: GPSBackboneConfig):
        super().__init__()
        self.seq_len = configs.seq_len
        self.pred_len = configs.pred_len

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.new_zeros(x.shape[0], self.pred_len, 2)


class LinearBaseline(nn.Module):
    """Repeats the mean of the last 5 velocities."""

    def __init__(self, configs: GPSBackboneConfig):
        super().__init__()
        self.seq_len = configs.seq_len
        self.pred_len = configs.pred_len

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        average = x[:, -5:, :2].mean(dim=1, keepdim=True)
        return average.expand(-1, self.pred_len, -1)
