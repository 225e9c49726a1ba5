"""Autoformer/FEDformer shared layers (counterpart of
``routeformer_tpu/models/layers/autoformer_layers.py``).

- ``SeasonalLayerNorm``: LayerNorm with the per-sequence mean re-subtracted.
- ``autoformer_moving_avg`` / ``SeriesDecomp`` / ``SeriesDecompMulti``:
  the edge-replicated moving-average trend split in its cumsum form, with
  the Autoformer padding convention (front ``k-1-floor((k-1)/2)``, end
  ``floor((k-1)/2)``).
- ``AutoformerEncoderLayer`` / ``AutoformerEncoder``: the
  progressive-decomposition encoder (bias-free position-wise FFN).
- ``AutoformerDecoderLayer`` / ``AutoformerDecoder``: the decoder
  accumulating the trend stream through a circular kernel-3 projection.
- ``AutoCorrelationLayer``: q/k/v/out projections around the FFT
  autocorrelation (``ops/attention.autocorrelation_attention``: delays
  shared by the batch in training, per row in eval, as ``module.training``
  says) or around a FEDformer block given as ``inner``.
"""

from typing import List, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.models.layers.encdec import LN_EPS, feature_dropout
from routeformer_torch.ops.attention import autocorrelation_attention


class SeasonalLayerNorm(nn.Module):
    """LayerNorm minus the temporal mean."""

    def __init__(self, channels: int):
        super().__init__()
        self.layernorm = nn.LayerNorm(channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_hat = self.layernorm(x)
        return x_hat - x_hat.mean(dim=1, keepdim=True)


def autoformer_moving_avg(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Edge-replicated moving average over time of ``(B, L, C)``."""
    end_pad = (kernel_size - 1) // 2
    front_pad = kernel_size - 1 - end_pad
    xp = torch.cat([x[:, :1].expand(-1, front_pad, -1), x,
                    x[:, -1:].expand(-1, end_pad, -1)], dim=1)
    c = torch.cumsum(torch.cat([torch.zeros_like(xp[:, :1]), xp], dim=1), dim=1)
    return (c[:, kernel_size:] - c[:, :-kernel_size]) / kernel_size


class SeriesDecomp(nn.Module):
    """Residual/trend split."""

    def __init__(self, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size

    def forward(self, x: torch.Tensor):
        moving_mean = autoformer_moving_avg(x, self.kernel_size)
        return x - moving_mean, moving_mean


class SeriesDecompMulti(nn.Module):
    """Softmax-weighted multi-kernel decomposition."""

    def __init__(self, kernel_sizes: List[int]):
        super().__init__()
        self.kernel_sizes = list(kernel_sizes)
        self.layer = nn.Linear(1, len(kernel_sizes))

    def forward(self, x: torch.Tensor):
        means = torch.stack([autoformer_moving_avg(x, k) for k in self.kernel_sizes],
                            dim=-1)  # (B, L, C, K)
        weights = torch.softmax(self.layer(x[..., None]), dim=-1)
        moving_mean = (means * weights).sum(dim=-1)
        return x - moving_mean, moving_mean


def make_decomp(moving_avg: Union[int, List[int]]) -> nn.Module:
    if isinstance(moving_avg, (list, tuple)):
        return SeriesDecompMulti(list(moving_avg))
    return SeriesDecomp(moving_avg)


def _activation(name: str):
    return F.relu if name == "relu" else F.gelu  # the exact erf form, as JAX's


class AutoCorrelationLayer(nn.Module):
    """Projections around the autocorrelation (``inner=None``) or a
    FEDformer block. The inner output is merged with a raw row-major
    reshape to ``(B, L, -1)`` whatever its layout, as the reference's
    ``view`` (FourierBlock returns head-major ``(B, H, E, L)``)."""

    def __init__(self, d_model: int, n_heads: int, factor: int = 1,
                 d_keys: Optional[int] = None, d_values: Optional[int] = None,
                 inner: Optional[nn.Module] = None):
        super().__init__()
        d_keys = d_keys or d_model // n_heads
        d_values = d_values or d_model // n_heads
        self.query_projection = nn.Linear(d_model, d_keys * n_heads)
        self.key_projection = nn.Linear(d_model, d_keys * n_heads)
        self.value_projection = nn.Linear(d_model, d_values * n_heads)
        self.out_projection = nn.Linear(d_values * n_heads, d_model)
        self.n_heads = n_heads
        self.factor = factor
        self.inner = inner
        # the data shards' group on a mesh with several (set by the trainer):
        # the training delays are then the global batch's
        self.data_group = None

    def forward(self, queries, keys, values, attn_mask=None):
        b, l, _ = queries.shape
        s = keys.shape[1]
        h = self.n_heads
        q = self.query_projection(queries).reshape(b, l, h, -1)
        k = self.key_projection(keys).reshape(b, s, h, -1)
        v = self.value_projection(values).reshape(b, s, h, -1)
        if self.inner is None:
            out, attn = autocorrelation_attention(q, k, v, factor=self.factor,
                                                  training=self.training,
                                                  data_group=self.data_group)
        else:
            out, attn = self.inner(q, k, v, attn_mask)
        return self.out_projection(out.reshape(b, l, -1)), attn


class AutoformerEncoderLayer(nn.Module):
    """Progressive-decomposition encoder layer."""

    mesh_gather_unit = True  # a mesh gathers the layer's weights together
    # ff1's output reaches ff2 through elementwise ops only: on a mesh it
    # stays split over ``model`` between the two
    mesh_split_pairs = (("ff1", "ff2"),)

    def __init__(self, attention: nn.Module, d_model: int, d_ff: Optional[int] = None,
                 moving_avg: Union[int, List[int]] = 25, dropout: float = 0.1,
                 activation: str = "relu"):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.attention = attention
        self.ff1 = nn.Linear(d_model, d_ff, bias=False)
        self.ff2 = nn.Linear(d_ff, d_model, bias=False)
        self.decomp1 = make_decomp(moving_avg)
        self.decomp2 = make_decomp(moving_avg)
        self.dropout = nn.Dropout(dropout)
        self.activation = _activation(activation)

    def forward(self, x, attn_mask=None):
        new_x, attn = self.attention(x, x, x, attn_mask=attn_mask)
        x, _ = self.decomp1(x + self.dropout(new_x))
        y = feature_dropout(self.dropout, self.activation(self.ff1(x)), self.ff1)
        y = self.dropout(self.ff2(y))
        res, _ = self.decomp2(x + y)
        return res, attn


class AutoformerEncoder(nn.Module):
    def __init__(self, attn_layers, norm_layer: Optional[nn.Module] = None):
        super().__init__()
        self.attn_layers = nn.ModuleList(attn_layers)
        self.norm = norm_layer

    def forward(self, x, attn_mask=None):
        attns = []
        for layer in self.attn_layers:
            x, attn = layer(x, attn_mask=attn_mask)
            attns.append(attn)
        if self.norm is not None:
            x = self.norm(x)
        return x, attns


class AutoformerDecoderLayer(nn.Module):
    """Decoder layer accumulating a trend stream."""

    mesh_gather_unit = True  # a mesh gathers the layer's weights together
    mesh_split_pairs = (("ff1", "ff2"),)  # as AutoformerEncoderLayer's

    def __init__(self, self_attention: nn.Module, cross_attention: nn.Module, d_model: int,
                 c_out: int, d_ff: Optional[int] = None,
                 moving_avg: Union[int, List[int]] = 25, dropout: float = 0.1,
                 activation: str = "relu"):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.self_attention = self_attention
        self.cross_attention = cross_attention
        self.ff1 = nn.Linear(d_model, d_ff, bias=False)
        self.ff2 = nn.Linear(d_ff, d_model, bias=False)
        self.decomp1 = make_decomp(moving_avg)
        self.decomp2 = make_decomp(moving_avg)
        self.decomp3 = make_decomp(moving_avg)
        self.dropout = nn.Dropout(dropout)
        # circular kernel-3 conv projecting the trend to the output channels
        # (on a mesh a row split over d_model: it slices the padded (B, C, L)
        # input's channels)
        self.projection = nn.Conv1d(d_model, c_out, 3, bias=False)
        self.activation = _activation(activation)

    def forward(self, x, cross, x_mask=None, cross_mask=None):
        x = x + self.dropout(self.self_attention(x, x, x, attn_mask=x_mask)[0])
        x, trend1 = self.decomp1(x)
        x = x + self.dropout(self.cross_attention(x, cross, cross, attn_mask=cross_mask)[0])
        x, trend2 = self.decomp2(x)
        y = feature_dropout(self.dropout, self.activation(self.ff1(x)), self.ff1)
        y = self.dropout(self.ff2(y))
        x, trend3 = self.decomp3(x + y)
        trend = F.pad((trend1 + trend2 + trend3).transpose(1, 2), (1, 1), mode="circular")
        return x, self.projection(trend).transpose(1, 2)


class AutoformerDecoder(nn.Module):
    def __init__(self, layers, norm_layer: Optional[nn.Module] = None,
                 projection: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm_layer
        self.projection = projection

    def forward(self, x, cross, x_mask=None, cross_mask=None, trend=None):
        for layer in self.layers:
            x, residual_trend = layer(x, cross, x_mask=x_mask, cross_mask=cross_mask)
            trend = trend + residual_trend
        if self.norm is not None:
            x = self.norm(x)
        if self.projection is not None:
            x = self.projection(x)
        return x, trend
