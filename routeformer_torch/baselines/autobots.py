"""AutoBot-Ego baseline (counterpart of
``routeformer_tpu/baselines/autobots.py``): a temporal and social attention
encoder over the ego velocities, a learnable-query decoder producing ``c``
bivariate-Gaussian modes, and mode probabilities from learnable seeds.
``AutoBotAdapted`` integrates the probability-weighted mean velocity onto
the last GPS fix.

The blocks are post-norm with a ReLU FFN (torch's Transformer layer
defaults) and LayerNorm eps 1e-6 (flax's). The decoder folds the modes
into the batch as the JAX package does: the context repeats each sample
``c`` times (``jnp.repeat``) and the queries tile the modes
(``jnp.tile``), so row ``i`` is sample ``i // c``, mode ``i % c``.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.models.layers.embed import sinusoidal_table
from routeformer_torch.models.layers.encdec import LN_EPS
from routeformer_torch.ops.attention import dot_product_attention


class _MHA(nn.Module):
    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.wq = nn.Linear(d_model, d_model)
        self.wk = nn.Linear(d_model, d_model)
        self.wv = nn.Linear(d_model, d_model)
        self.wo = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, causal=False):
        b, l, d = q.shape
        s, h = k.shape[1], self.n_heads
        out = dot_product_attention(self.wq(q).reshape(b, l, h, d // h),
                                    self.wk(k).reshape(b, s, h, d // h),
                                    self.wv(v).reshape(b, s, h, d // h), causal=causal)
        return self.wo(out.reshape(b, l, d))


class _EncoderBlock(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, dropout):
        super().__init__()
        self.attn = _MHA(d_model, n_heads)
        self.ff1 = nn.Linear(d_model, d_ff)
        self.ff2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        x = self.norm1(x + self.dropout(self.attn(x, x, x)))
        y = self.ff2(self.dropout(F.relu(self.ff1(x))))
        return self.norm2(x + self.dropout(y))


class _DecoderBlock(nn.Module):
    def __init__(self, d_model, n_heads, d_ff, dropout):
        super().__init__()
        self.self_attn = _MHA(d_model, n_heads)
        self.cross_attn = _MHA(d_model, n_heads)
        self.ff1 = nn.Linear(d_model, d_ff)
        self.ff2 = nn.Linear(d_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.dropout = nn.Dropout(dropout)

    def forward(self, tgt, memory):
        tgt = self.norm1(tgt + self.dropout(self.self_attn(tgt, tgt, tgt, causal=True)))
        tgt = self.norm2(tgt + self.dropout(self.cross_attn(tgt, memory, memory)))
        y = self.ff2(self.dropout(F.relu(self.ff1(tgt))))
        return self.norm3(tgt + self.dropout(y))


class OutputModel(nn.Module):
    """``(B, T, d_k) -> (B, T, 5)``: means, softplus sigmas + 0.01, 0.9 tanh rho."""

    def __init__(self, d_k: int = 64):
        super().__init__()
        self.l1 = nn.Linear(d_k, d_k)
        self.l2 = nn.Linear(d_k, d_k)
        self.l3 = nn.Linear(d_k, 5)
        self.min_stdev = 0.01

    def forward(self, x):
        p = self.l3(F.relu(self.l2(F.relu(self.l1(x)))))
        return torch.stack([p[..., 0], p[..., 1],
                            F.softplus(p[..., 2]) + self.min_stdev,
                            F.softplus(p[..., 3]) + self.min_stdev,
                            torch.tanh(p[..., 4]) * 0.9], dim=-1)


class AutoBotEgo(nn.Module):
    def __init__(self, d_k: int = 128, c: int = 5, T: int = 30, L_enc: int = 1,
                 dropout: float = 0.0, k_attr: int = 2, num_heads: int = 16,
                 L_dec: int = 1, tx_hidden_size: int = 384):
        super().__init__()
        self.d_k, self.c, self.T = d_k, c, T
        self.agents_dynamic_encoder = nn.Linear(k_attr, d_k)
        block = (d_k, num_heads, tx_hidden_size, dropout)
        self.temporal_attn_layers = nn.ModuleList([_EncoderBlock(*block) for _ in range(L_enc)])
        self.social_attn_layers = nn.ModuleList([_EncoderBlock(*block) for _ in range(L_enc)])
        self.Q = nn.Parameter(torch.randn(T, 1, c, d_k) / math.sqrt(d_k))
        self.tx_decoder = nn.ModuleList([_DecoderBlock(*block) for _ in range(L_dec)])
        self.register_buffer("pos_table", sinusoidal_table(100, d_k), persistent=False)
        self.output_model = OutputModel(d_k)
        self.P = nn.Parameter(torch.randn(c, 1, d_k) / math.sqrt(d_k))
        self.prob_decoder = _MHA(d_k, num_heads)
        self.prob_predictor = nn.Linear(d_k, 1)

    def forward(self, ego_in: torch.Tensor):
        """``ego_in (B, T_obs, k_attr + 1)`` (the last channel is the
        existence mask, constant for the ego agent) -> ``(out_dists (c, T, B,
        5), mode_probs (B, c))``."""
        b, t_obs, _ = ego_in.shape
        emb = self.agents_dynamic_encoder(ego_in[:, :, :2])
        for temporal, social in zip(self.temporal_attn_layers, self.social_attn_layers):
            emb = temporal(emb + self.pos_table[None, :t_obs])
            # social attention over the one ego agent: one token per step
            emb = social(emb.reshape(b * t_obs, 1, self.d_k)).reshape(b, t_obs, self.d_k)
        context = torch.repeat_interleave(emb, self.c, dim=0)
        out_seq = self.Q.permute(1, 2, 0, 3).reshape(self.c, self.T, self.d_k).repeat(b, 1, 1)
        for layer in self.tx_decoder:
            out_seq = layer(out_seq, context)
        out_dists = self.output_model(out_seq).reshape(b, self.c, self.T, 5).permute(1, 2, 0, 3)
        mode_seed = self.P.permute(1, 0, 2).repeat(b, 1, 1)
        logits = self.prob_predictor(self.prob_decoder(mode_seed, emb, emb))[..., 0]
        return out_dists, torch.softmax(logits, dim=-1)


class AutoBotAdapted(nn.Module):
    """The ego-only adapter over a ``RouteformerConfig``: GPS velocities in,
    future GPS ``(B, pred_len, 2)`` out."""

    def __init__(self, configs):
        super().__init__()
        self.configs = configs
        g = configs.gps_backbone_config
        self.model = AutoBotEgo(d_k=configs.encoder_hidden_size, c=5, T=g.pred_len,
                                L_enc=g.e_layers, dropout=0.0, k_attr=2,
                                num_heads=configs.encoder_heads, L_dec=g.d_layers,
                                tx_hidden_size=configs.encoder_d_ff)

    def forward(self, batch: dict):
        gps = batch["gps"].float()
        motions = F.pad(gps[:, 1:] - gps[:, :-1], (0, 0, 1, 0))
        motions = torch.cat([motions, torch.ones_like(motions[:, :, :1])], dim=2)
        out_dists, mode_probs = self.model(motions)
        probs = mode_probs.t()[:, None, :]  # (c, 1, B)
        expected = (out_dists[..., :2] * probs[..., None]).sum(dim=0)  # (T, B, 2)
        return gps[:, -1:] + torch.cumsum(expected.transpose(0, 1), dim=1)
