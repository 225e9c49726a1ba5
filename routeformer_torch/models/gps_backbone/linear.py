"""LTSF-Linear GPS backbones, DLinear and NLinear (counterpart of
``routeformer_tpu/models/gps_backbone/linear.py``): a linear map over time,
on a moving-average trend and its residual (DLinear) or on the series less
its last value (NLinear). With ``individual`` each channel has its own map,
one stacked ``(C, L_in, L_out)`` weight as in the JAX package."""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.models.gps_backbone.config import GPSBackboneConfig


def moving_average(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Edge-replicated moving average over time: ``(B, L, C) -> (B, L, C)``
    for odd kernels, ``(k - 1) // 2`` copies of each end value as padding."""
    pad = (kernel_size - 1) // 2
    xp = torch.cat([x[:, :1].expand(-1, pad, -1), x, x[:, -1:].expand(-1, pad, -1)], dim=1)
    c = torch.cumsum(F.pad(xp, (0, 0, 1, 0)), dim=1)
    return (c[:, kernel_size:] - c[:, :-kernel_size]) / kernel_size


def series_decomp(x: torch.Tensor, kernel_size: int):
    """``(residual, trend)``."""
    trend = moving_average(x, kernel_size)
    return x - trend, trend


class _TimeLinear(nn.Module):
    """A linear map over the time axis, ``(B, L, C) -> (B, pred_len, C)``,
    shared by the channels or one per channel (``individual``)."""

    def __init__(self, seq_len: int, pred_len: int, channels: int, individual: bool):
        super().__init__()
        self.individual = individual
        if individual:
            self.weight = nn.Parameter(
                torch.randn(channels, seq_len, pred_len) / math.sqrt(seq_len))
            self.bias = nn.Parameter(torch.zeros(channels, pred_len))
        else:
            self.linear = nn.Linear(seq_len, pred_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.individual:
            return torch.einsum("blc,clp->bpc", x, self.weight) + self.bias.t()[None]
        return self.linear(x.transpose(1, 2)).transpose(1, 2)


class DLinear(nn.Module):
    def __init__(self, configs: GPSBackboneConfig):
        super().__init__()
        self.pred_len = configs.pred_len
        self.c_out = configs.c_out
        self.kernel_size = configs.get("kernel_size", 25)
        args = (configs.seq_len, configs.pred_len, configs.enc_in, configs.individual)
        self.linear_seasonal = _TimeLinear(*args)
        self.linear_trend = _TimeLinear(*args)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seasonal, trend = series_decomp(x, self.kernel_size)
        out = self.linear_seasonal(seasonal) + self.linear_trend(trend)
        return out[:, : self.pred_len, : self.c_out]


class NLinear(nn.Module):
    def __init__(self, configs: GPSBackboneConfig):
        super().__init__()
        self.pred_len = configs.pred_len
        self.c_out = configs.c_out
        self.linear = _TimeLinear(configs.seq_len, configs.pred_len, configs.enc_in,
                                  configs.individual)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq_last = x[:, -1:].detach()
        out = self.linear(x - seq_last) + seq_last
        return out[:, : self.pred_len, : self.c_out]
