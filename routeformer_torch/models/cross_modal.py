"""Perceiver-style cross-modal encoder/decoder (counterpart of
``routeformer_tpu/models/cross_modal.py``).

The JAX package scans its encoder layers; here they are a ``ModuleList``
named ``stacked_layers`` (``convert.py`` unstacks the scanned weights).
``ROUTEFORMER_FUSION_KERNEL`` selects the fused stack
(``ops/fusion_stack.py``, K3a/K3b) with the JAX package's values: unset or
``0`` the plain stack (the default); ``1``/``tpu``/``interpret`` the fused
forward and backward; ``hybrid``/``hybrid-interpret`` the fused forward with
a recompute backward. The fused stack runs its kernels on CUDA tensors and
their plain versions on CPU tensors, and only replaces the masked
ProbSparse formulation (``ROUTEFORMER_PROBSPARSE``). With
``compute_dtype="bfloat16"`` the attention and FFN Linear layers compute in
bf16; LayerNorms, the token embedding and the output projection stay f32.
"""

import operator
import os
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
from routeformer_torch.ops.fusion_stack import (
    KernelWeights,
    StackWeights,
    fused_perceive_stack,
    kernel_weights,
    make_dropout_masks,
    prob_sparse_u,
    sample_count_matrices,
)
from routeformer_torch.ops.weight_cache import derived

# Each StackWeights field's parameter inside an EncoderLayer, in field order.
_STACK_PATHS = [
    f"{module}.{kind}"
    for module in ("attention.query_projection", "attention.key_projection",
                   "attention.value_projection", "attention.out_projection", "norm1",
                   "ff1", "ff2", "norm2")
    for kind in ("weight", "bias")
]


def torch_dtype(compute_dtype: Optional[str]) -> Optional[torch.dtype]:
    return torch.bfloat16 if compute_dtype == "bfloat16" else None


class PerceiveEncoder(nn.Module):
    """ProbSparse self-attention encoder emitting the last ``out_len`` tokens."""

    # A mesh gathers the whole stack's weights together: K3a and K3b take
    # every layer's weights in one call.
    mesh_gather_unit = True

    def __init__(self, in_channels: int, out_channels: int, out_len: int,
                 factor: int = 5, d_model: int = 128, n_heads: int = 8,
                 layers: int = 3, d_ff: Optional[int] = None,
                 dropout: float = 0.1, activation: str = "gelu",
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.pred_len = out_len
        dt = torch_dtype(compute_dtype)
        d_ff = d_ff if d_ff is not None else 4 * d_model
        self.d_model, self.n_heads = d_model, n_heads
        self.dropout_rate, self.activation = dropout, activation
        self.compute_bf16 = compute_dtype == "bfloat16"
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

    def mesh_whole_weights(self) -> bool:
        """K3a/K3b take the stack's whole weights; the plain layers' Linear
        layers split on a mesh."""
        return self.fused_kernel_mode() is not None

    def fused_kernel_mode(self) -> Optional[str]:
        """"kernel", "hybrid", or None for the plain layer stack."""
        if self.d_model % self.n_heads:
            return None
        mode = os.getenv("ROUTEFORMER_FUSION_KERNEL", "0")
        if mode in ("0", "auto"):
            return None
        if os.getenv("ROUTEFORMER_PROBSPARSE", "masked") != "masked":
            return None
        return "hybrid" if mode in ("hybrid", "hybrid-interpret") else "kernel"

    def _stack_params(self) -> list:
        """Every layer's parameter of each ``StackWeights`` field, in field order."""
        return [operator.attrgetter(path)(layer) for path in _STACK_PATHS
                for layer in self.stacked_layers]

    def stack_weights(self) -> StackWeights:
        """The layers' parameters stacked over layers, (in, out) matrices;
        built once and reused until a parameter is replaced or updated in
        place (``weight_cache.derived``; afresh while autograd records
        through them)."""
        def build(*params):
            n = len(self.stacked_layers)
            return StackWeights(*(
                torch.stack([t.t() if t.ndim == 2 else t for t in params[i:i + n]])
                for i in range(0, len(params), n)))

        return derived("perceive_stack", build, *self._stack_params())

    def kernel_weights(self) -> KernelWeights:
        """K3a/K3b's derived weights (``fusion_stack.kernel_weights``),
        cached as ``stack_weights`` but also while autograd records: the
        kernels' backward returns the gradients of ``stack_weights``."""
        return derived("perceive_kernel",
                       lambda *params: kernel_weights(self.stack_weights()),
                       *self._stack_params(), differentiable=False)

    def _run_fused_stack(self, x: torch.Tensor, backward: str) -> torch.Tensor:
        """ProbSparse key samples as the plain layers draw them (the fixed
        eval sample, fresh draws in training or from the Monte-Carlo eval's
        generator; the layers' own factor) and dropout keep-masks in
        training, then the fused stack."""
        n_layers = len(self.stacked_layers)
        r, l, d = x.shape
        attention = self.stacked_layers[0].attention.inner_attention
        factor = attention.factor
        u_part = prob_sparse_u(l, factor)
        cnt = sample_count_matrices(n_layers, l, l, u_part,
                                    train=self.training or attention.mc_generator is not None,
                                    generator=attention.sample_generator(), device=x.device)
        train_dropout = self.training and self.dropout_rate > 0.0
        masks = (
            make_dropout_masks(n_layers, r, l, d, self.stacked_layers[0].ff1.out_features,
                               self.dropout_rate, device=x.device)
            if train_dropout else None
        )
        return fused_perceive_stack(
            x, self.stack_weights(), cnt, masks, heads=self.n_heads,
            factor=factor,
            dropout_rate=self.dropout_rate if train_dropout else 0.0,
            activation=self.activation, compute_bf16=self.compute_bf16,
            backward=backward,
            kernel_w=None if x.device.type == "cpu" else self.kernel_weights(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.value_embedding(x) + self.position_embedding(x)
        mode = self.fused_kernel_mode()
        if mode is not None:
            h = self._run_fused_stack(h, mode)
        else:
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
                    AttentionLayer(FullAttention(False, attention_dropout=dropout),
                                   d_model, n_heads, mix=False, compute_dtype=dt),
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
