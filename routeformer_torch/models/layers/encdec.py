"""Encoder/decoder stacks with Informer distillation (counterpart of
``routeformer_tpu/models/layers/encdec.py``).

LayerNorm eps is 1e-6 here, the nnx default, not torch's 1e-5.
"""

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.models.layers.attention import Linear

LN_EPS = 1e-6


def activation_fn(name: str):
    if name == "relu":
        return F.relu
    return F.gelu  # the exact erf form, as the JAX package uses


def feature_dropout(dropout: nn.Dropout, x: torch.Tensor, producer: nn.Module) -> torch.Tensor:
    """``dropout(x)``, where ``x`` is ``producer``'s output through
    elementwise ops. Where a mesh's ``model`` axis keeps that output split
    over the ranks (``parallel/mesh.py``: ``producer.mesh_split``), the mask
    is drawn on the whole activation and cut to the rank's columns
    (``_Split.dropout``)."""
    split = getattr(producer, "mesh_split", None)
    return dropout(x) if split is None else split.dropout(dropout, x)


class ConvLayer(nn.Module):
    """Distillation stage: circular pad, VALID kernel-3 conv, BatchNorm
    (running stats in eval, eps 1e-5), ELU, MaxPool(3, 2, pad 1). On a mesh
    with several data shards (``data_group``, set by the trainer) the
    training statistics are the global batch's."""

    def __init__(self, c_in: int, extra_padding: int = 2):
        super().__init__()
        self.extra_padding = extra_padding
        self.conv = nn.Conv1d(c_in, c_in, 3)
        self.norm = nn.BatchNorm1d(c_in, eps=1e-5, momentum=0.1)
        self.data_group = None

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.data_group is None:
            return self.norm(x)
        from routeformer_torch.parallel.mesh import global_moments

        bn = self.norm
        mean, var, n = global_moments(x, (0, 2), self.data_group)
        with torch.no_grad():  # BatchNorm1d's update: the unbiased variance
            bn.running_mean.mul_(1 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1 - bn.momentum).add_(bn.momentum * var * n / (n - 1))
            bn.num_batches_tracked += 1
        scale = torch.rsqrt(var + bn.eps) * bn.weight
        return (x - mean[:, None]) * scale[:, None] + bn.bias[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.extra_padding
        x = torch.cat([x[:, -p:], x, x[:, :p]], dim=1).transpose(1, 2)
        x = F.elu(self._norm(self.conv(x)))
        x = F.max_pool1d(x, 3, stride=2, padding=1)
        return x.transpose(1, 2)


class EncoderLayer(nn.Module):
    mesh_gather_unit = True  # a mesh gathers the layer's weights together
    # ff1's output reaches ff2 through elementwise ops only: on a mesh it
    # stays split over ``model`` between the two
    mesh_split_pairs = (("ff1", "ff2"),)

    def __init__(self, attention: nn.Module, d_model: int,
                 d_ff: Optional[int] = None, dropout: float = 0.1,
                 activation: str = "relu",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.attention = attention
        self.ff1 = Linear(d_model, d_ff, compute_dtype=compute_dtype)
        self.ff2 = Linear(d_ff, d_model, compute_dtype=compute_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.activation = activation_fn(activation)

    def forward(self, x: torch.Tensor):
        """The layer's output; ``(output, attention)`` where the attention
        layer returns its attention (``output_attention``)."""
        a = self.attention(x, x, x)
        with_attn = isinstance(a, tuple)
        a, attn = a if with_attn else (a, None)
        x = x + self.dropout(a)
        y = x = self.norm1(x)
        y = feature_dropout(self.dropout, self.activation(self.ff1(y)), self.ff1)
        y = self.dropout(self.ff2(y))
        out = self.norm2(x + y)
        return (out, attn) if with_attn else out


class Encoder(nn.Module):
    def __init__(self, attn_layers: List[nn.Module],
                 conv_layers: Optional[List[nn.Module]] = None,
                 norm_layer: Optional[nn.Module] = None):
        super().__init__()
        self.attn_layers = nn.ModuleList(attn_layers)
        self.conv_layers = (
            nn.ModuleList(conv_layers) if conv_layers is not None else None
        )
        self.norm = norm_layer

    def forward(self, x: torch.Tensor):
        """The encoded sequence; ``(encoded, attentions)``, one per layer,
        where the layers return their attention (``output_attention``)."""
        attns = []

        def attend(layer, x):
            out = layer(x)
            if isinstance(out, tuple):
                out, attn = out
                attns.append(attn)
            return out

        if self.conv_layers is not None:
            for attn_layer, conv_layer in zip(self.attn_layers, self.conv_layers):
                x = conv_layer(attend(attn_layer, x))
            x = attend(self.attn_layers[-1], x)
        else:
            for attn_layer in self.attn_layers:
                x = attend(attn_layer, x)
        if self.norm is not None:
            x = self.norm(x)
        return (x, attns) if attns else x


class DecoderLayer(nn.Module):
    mesh_gather_unit = True  # a mesh gathers the layer's weights together
    mesh_split_pairs = (("ff1", "ff2"),)  # as EncoderLayer's

    def __init__(self, self_attention: nn.Module, cross_attention: nn.Module,
                 d_model: int, d_ff: Optional[int] = None,
                 dropout: float = 0.1, activation: str = "relu",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.self_attention = self_attention
        self.cross_attention = cross_attention
        self.ff1 = Linear(d_model, d_ff, compute_dtype=compute_dtype)
        self.ff2 = Linear(d_ff, d_model, compute_dtype=compute_dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)
        self.activation = activation_fn(activation)

    def forward(self, x: torch.Tensor, cross: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout(self.self_attention(x, x, x)))
        x = x + self.dropout(self.cross_attention(x, cross, cross))
        y = x = self.norm2(x)
        y = feature_dropout(self.dropout, self.activation(self.ff1(y)), self.ff1)
        y = self.dropout(self.ff2(y))
        return self.norm3(x + y)


class Decoder(nn.Module):
    def __init__(self, layers: List[nn.Module],
                 norm_layer: Optional[nn.Module] = None,
                 projection: Optional[nn.Module] = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = norm_layer
        self.projection = projection

    def forward(self, x: torch.Tensor, cross: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, cross)
        if self.norm is not None:
            x = self.norm(x)
        if self.projection is not None:
            x = self.projection(x)
        return x
