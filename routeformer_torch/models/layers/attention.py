"""Attention modules (counterpart of
``routeformer_tpu/models/layers/attention.py``).

``AttentionLayer`` keeps the Informer ``mix`` quirk: with ``mix=True`` the
per-head outputs merge from the head-major layout ``(B, H, L, D) ->
(B, L, H*D)``. ``ProbAttention`` in eval mode draws its key sample as the
JAX package does (``utils/prng.py``) and in training draws a fresh one from
the device's default generator; it applies no dropout, as in the JAX
package. ``FullAttention`` drops attention weights in training. With
``mc_generator`` set (the trainer's Monte-Carlo eval, ``set_mc_sampling``)
``ProbAttention`` draws fresh key samples in eval too, from that generator;
with ``shared_generator`` set (a mesh with several data shards) its
training key samples come from that stream, the same on every rank, as
JAX draws one sample for the global batch.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.ops.attention import (
    dot_product_attention,
    prob_sparse_attention,
)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (params stay f32), as
    ``nnx.Linear(dtype=...)`` does: input, weight and bias are cast."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class FullAttention(nn.Module):
    """Dense softmax attention (causal when ``mask_flag``); with
    ``output_attention`` it returns ``(out, weights)``, the f32 ``(B, H,
    L, S)`` softmax weights before dropout."""

    def __init__(self, mask_flag: bool = True, scale: Optional[float] = None,
                 attention_dropout: float = 0.0, output_attention: bool = False):
        super().__init__()
        self.mask_flag = mask_flag
        self.scale = scale
        self.attention_dropout = attention_dropout
        self.output_attention = output_attention

    def forward(self, q, k, v):
        return dot_product_attention(
            q, k, v, causal=self.mask_flag, scale=self.scale,
            dropout_rate=self.attention_dropout if self.training else 0.0,
            need_weights=self.output_attention,
        )


class ProbAttention(nn.Module):
    """Informer ProbSparse top-u attention (masked formulation); with
    ``output_attention`` it returns ``(out, None)``: like the JAX package,
    it keeps no attention map."""

    def __init__(self, mask_flag: bool = True, factor: int = 5,
                 scale: Optional[float] = None, output_attention: bool = False):
        super().__init__()
        self.mask_flag = mask_flag
        self.factor = factor
        self.scale = scale
        self.output_attention = output_attention
        self.mc_generator: Optional[torch.Generator] = None
        self.shared_generator: Optional[torch.Generator] = None

    def sample_generator(self) -> Optional[torch.Generator]:
        """The key samples' generator: the MC eval's, else the mesh's
        shared stream, else None (the device's default)."""
        return self.mc_generator if self.mc_generator is not None else self.shared_generator

    def forward(self, q, k, v):
        out = prob_sparse_attention(
            q, k, v, factor=self.factor, causal=self.mask_flag,
            scale=self.scale, train=self.training or self.mc_generator is not None,
            generator=self.sample_generator(),
        )
        return (out, None) if self.output_attention else out


class AttentionLayer(nn.Module):
    """q/k/v/out projections around an inner attention."""

    def __init__(self, attention: nn.Module, d_model: int, n_heads: int,
                 mix: bool = False, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d_keys = d_model // n_heads
        self.inner_attention = attention
        self.query_projection = Linear(d_model, d_keys * n_heads,
                                       compute_dtype=compute_dtype)
        self.key_projection = Linear(d_model, d_keys * n_heads,
                                     compute_dtype=compute_dtype)
        self.value_projection = Linear(d_model, d_keys * n_heads,
                                       compute_dtype=compute_dtype)
        self.out_projection = Linear(d_keys * n_heads, d_model,
                                     compute_dtype=compute_dtype)
        self.n_heads = n_heads
        self.mix = mix

    def forward(self, queries, keys, values):
        """The projected output; ``(output, attention)`` where the inner
        attention returns its attention too (``output_attention``)."""
        b, l, _ = queries.shape
        s = keys.shape[1]
        h = self.n_heads
        q = self.query_projection(queries).reshape(b, l, h, -1)
        k = self.key_projection(keys).reshape(b, s, h, -1)
        v = self.value_projection(values).reshape(b, s, h, -1)
        out = self.inner_attention(q, k, v)
        attn = None
        if isinstance(out, tuple):
            out, attn = out
        if self.mix:
            out = out.transpose(1, 2)  # Informer quirk: head-major merge
        out = self.out_projection(out.reshape(b, l, -1))
        return (out, attn) if getattr(self.inner_attention, "output_attention", False) else out
