"""Embedding layers on channel-last ``(B, L, C)`` tokens (counterpart of
``routeformer_tpu/models/layers/embed.py``)."""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class TokenEmbedding(nn.Module):
    """Kernel-3 circular conv over time. ``use_bias`` is False for the
    gps-backbone variant and True for the cross-modal one."""

    def __init__(self, c_in: int, d_model: int, use_bias: bool = False):
        super().__init__()
        self.conv = nn.Conv1d(c_in, d_model, 3, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        x = F.pad(x, (1, 1), mode="circular")
        return self.conv(x).transpose(1, 2)


def sinusoidal_table(length: int, d_model: int, device=None) -> torch.Tensor:
    """The classic ``(length, d_model)`` sin/cos table, f32."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / d_model)
    )
    pe = torch.zeros(length, d_model, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term)
    return pe


class PositionalEmbedding(nn.Module):
    """Sinusoidal positional encoding ``(1, L, d_model)``."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sinusoidal_table(x.shape[1], self.d_model, x.device)[None]


class TimeFeatureEmbedding(nn.Module):
    """Bias-free Linear on continuous time features (timeF)."""

    FREQ_MAP = {"h": 4, "t": 5, "s": 6, "m": 1, "a": 1, "w": 2, "d": 3, "b": 3}

    def __init__(self, d_model: int, freq: str = "h"):
        super().__init__()
        self.linear = nn.Linear(self.FREQ_MAP[freq], d_model, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class DataEmbedding(nn.Module):
    """value + timeF temporal + positional embedding, then dropout."""

    def __init__(self, c_in: int, d_model: int, embed_type: str = "timeF",
                 freq: str = "m", dropout: float = 0.1):
        super().__init__()
        if embed_type != "timeF":
            raise NotImplementedError(
                f"embed={embed_type!r}: only the timeF embedding is ported"
            )
        self.value_embedding = TokenEmbedding(c_in, d_model)
        self.position_embedding = PositionalEmbedding(d_model)
        self.temporal_embedding = TimeFeatureEmbedding(d_model, freq)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, x_mark: torch.Tensor) -> torch.Tensor:
        out = (
            self.value_embedding(x)
            + self.temporal_embedding(x_mark)
            + self.position_embedding(x)
        )
        return self.dropout(out)
