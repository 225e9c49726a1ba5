"""Perceiver-style cross-modal encoder/decoder (counterpart of
``routeformer_tpu/models/cross_modal.py``).

The JAX package scans its encoder layers; here they are a ``ModuleList``
named ``stacked_layers`` (``convert.py`` unstacks the scanned weights). Its
fused-stack kernel is opt-in there, so the plain stack is the default here
too. With ``compute_dtype="bfloat16"`` the attention and FFN Linear layers
compute in bf16; LayerNorms, the token embedding and the output projection
stay f32.
"""

from typing import Optional

import torch
import torch.nn as nn

from routeformer_torch.models.layers import (
    AttentionLayer,
    Decoder,
    DecoderLayer,
    EncoderLayer,
    FullAttention,
    PositionalEmbedding,
    ProbAttention,
    TokenEmbedding,
)
from routeformer_torch.models.layers.encdec import LN_EPS


def torch_dtype(compute_dtype: Optional[str]) -> Optional[torch.dtype]:
    return torch.bfloat16 if compute_dtype == "bfloat16" else None


class PerceiveEncoder(nn.Module):
    """ProbSparse self-attention encoder emitting the last ``out_len`` tokens."""

    def __init__(self, in_channels: int, out_channels: int, out_len: int,
                 factor: int = 5, d_model: int = 128, n_heads: int = 8,
                 layers: int = 3, d_ff: Optional[int] = None,
                 dropout: float = 0.1, activation: str = "gelu",
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.pred_len = out_len
        dt = torch_dtype(compute_dtype)
        d_ff = d_ff if d_ff is not None else 4 * d_model
        self.value_embedding = TokenEmbedding(in_channels, d_model, use_bias=True)
        self.position_embedding = PositionalEmbedding(d_model)
        self.stacked_layers = nn.ModuleList(
            [
                EncoderLayer(
                    AttentionLayer(ProbAttention(False, factor), d_model,
                                   n_heads, mix=False, compute_dtype=dt),
                    d_model, d_ff, dropout=dropout, activation=activation,
                    compute_dtype=dt,
                )
                for _ in range(layers)
            ]
        )
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.projection = nn.Linear(d_model, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.value_embedding(x) + self.position_embedding(x)
        for layer in self.stacked_layers:
            h = layer(h)
        h = self.projection(self.norm(h))
        return h[:, -self.pred_len:]


class PerceiveDecoder(nn.Module):
    """Causal ProbSparse self-attention + dense cross-attention decoder."""

    def __init__(self, query_channels: int, value_channels: int,
                 out_channels: int, out_len: int, factor: int = 5,
                 n_heads: int = 8, layers: int = 2, d_ff: Optional[int] = None,
                 dropout: float = 0.1, activation: str = "gelu",
                 mix: bool = True, compute_dtype: Optional[str] = None):
        super().__init__()
        self.pred_len = out_len
        d_model = value_channels
        d_ff = d_ff if d_ff is not None else 4 * d_model
        dt = torch_dtype(compute_dtype)
        self.value_embedding = TokenEmbedding(query_channels, d_model,
                                              use_bias=True)
        self.position_embedding = PositionalEmbedding(d_model)
        self.decoder = Decoder(
            [
                DecoderLayer(
                    AttentionLayer(ProbAttention(True, factor), d_model,
                                   n_heads, mix=mix, compute_dtype=dt),
                    AttentionLayer(FullAttention(False), d_model, n_heads,
                                   mix=False, compute_dtype=dt),
                    d_model, d_ff, dropout=dropout, activation=activation,
                    compute_dtype=dt,
                )
                for _ in range(layers)
            ],
            norm_layer=nn.LayerNorm(d_model, eps=LN_EPS),
        )
        self.projection = nn.Linear(d_model, out_channels)

    def forward(self, x_enc: torch.Tensor, x_dec: torch.Tensor) -> torch.Tensor:
        """``x_enc``: the cross (key/value) sequence; ``x_dec``: the queries."""
        h = self.value_embedding(x_dec) + self.position_embedding(x_dec)
        h = self.decoder(h, x_enc)
        return self.projection(h)[:, -self.pred_len:]
