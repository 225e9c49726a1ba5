"""Embedding layers on channel-last ``(B, L, C)`` tokens (counterpart of
``routeformer_tpu/models/layers/embed.py``): the token conv, the
sinusoidal position, and the temporal embedding of time marks, either
``timeF`` (a Linear on continuous features) or calendar lookups summed
over (month, day, weekday, hour[, minute]), ``fixed`` (sinusoidal tables)
or ``learned`` (trained tables); ``DataEmbedding`` sums them,
``DataEmbedding_wo_pos`` drops the position and ``DataEmbedding_onlypos``
the temporal embedding."""

import math
from typing import Optional

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


class FixedEmbedding(nn.Module):
    """A non-trainable sinusoidal lookup table ``(c_in, d_model)``: a
    non-persistent buffer, as the JAX package keeps it out of its state."""

    def __init__(self, c_in: int, d_model: int):
        super().__init__()
        self.register_buffer("weight", sinusoidal_table(c_in, d_model), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight[x]


class Embed(nn.Module):
    """A trained lookup table, named as flax's ``nnx.Embed`` names it
    (``embedding``, normal with std 1/sqrt(features))."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.randn(num_embeddings, features)
                                      / math.sqrt(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding[x]


class TemporalEmbedding(nn.Module):
    """Calendar embeddings of integer marks ``(B, L, 4|5)`` (month, day,
    weekday, hour[, minute] with ``freq="t"``), summed; ``embed_type``
    ``fixed`` (sinusoidal tables) or ``learned``."""

    SIZES = {"minute": 4, "hour": 24, "weekday": 7, "day": 32, "month": 13}

    def __init__(self, d_model: int, embed_type: str = "fixed", freq: str = "h"):
        super().__init__()
        table = FixedEmbedding if embed_type == "fixed" else Embed
        self.minute_embed = table(self.SIZES["minute"], d_model) if freq == "t" else None
        self.hour_embed = table(self.SIZES["hour"], d_model)
        self.weekday_embed = table(self.SIZES["weekday"], d_model)
        self.day_embed = table(self.SIZES["day"], d_model)
        self.month_embed = table(self.SIZES["month"], d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.long()
        out = (self.hour_embed(x[:, :, 3]) + self.weekday_embed(x[:, :, 2])
               + self.day_embed(x[:, :, 1]) + self.month_embed(x[:, :, 0]))
        if self.minute_embed is not None:
            out = out + self.minute_embed(x[:, :, 4])
        return out


def temporal_embedding(d_model: int, embed_type: str, freq: str) -> nn.Module:
    if embed_type == "timeF":
        return TimeFeatureEmbedding(d_model, freq)
    if embed_type not in ("fixed", "learned"):
        raise ValueError(f"embed must be 'timeF', 'fixed' or 'learned', got {embed_type!r}")
    return TemporalEmbedding(d_model, embed_type, freq)


class DataEmbedding(nn.Module):
    """value + temporal + positional embedding, then dropout."""

    def __init__(self, c_in: int, d_model: int, embed_type: str = "timeF",
                 freq: str = "m", dropout: float = 0.1):
        super().__init__()
        self.value_embedding = TokenEmbedding(c_in, d_model)
        self.position_embedding = PositionalEmbedding(d_model)
        self.temporal_embedding = temporal_embedding(d_model, embed_type, freq)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, x_mark: torch.Tensor) -> torch.Tensor:
        out = (
            self.value_embedding(x)
            + self.temporal_embedding(x_mark)
            + self.position_embedding(x)
        )
        return self.dropout(out)


class DataEmbedding_wo_pos(nn.Module):
    """value + temporal embedding (no positional), then dropout."""

    def __init__(self, c_in: int, d_model: int, embed_type: str = "fixed",
                 freq: str = "h", dropout: float = 0.1):
        super().__init__()
        self.value_embedding = TokenEmbedding(c_in, d_model)
        self.temporal_embedding = temporal_embedding(d_model, embed_type, freq)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, x_mark: torch.Tensor) -> torch.Tensor:
        return self.dropout(self.value_embedding(x) + self.temporal_embedding(x_mark))


class DataEmbedding_onlypos(nn.Module):
    """value + positional embedding, then dropout."""

    def __init__(self, c_in: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.value_embedding = TokenEmbedding(c_in, d_model)
        self.position_embedding = PositionalEmbedding(d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, x_mark: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.dropout(self.value_embedding(x) + self.position_embedding(x))
