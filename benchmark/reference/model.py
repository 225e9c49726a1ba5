"""The plain reference of the Routeformer model: float32 PyTorch, no
kernels, no cache, no batching tricks, written from the model's equations
(Routeformer, arXiv:2312.08558; SwinV2, arXiv:2111.09883; DinoV2's ViT-B/14,
arXiv:2304.07193; Informer, arXiv:2012.07436) as the port lays out its
parameters, so that the benchmark can hand both the same weights by name.

It imports nothing of the program. What it shares with the program is
what the benchmark hands both sides: the weights, the inputs, and the
state of torch's random generators before a training step. A training
forward draws its random numbers (view, gaze and feature dropout,
ProbSparse's key samples) with the same torch calls, shapes, dtypes and
devices, in the same order, as the program's training forward does
(``Draws``), so that both see the same masks and samples.

``Precision`` rounds matmul operands: "f32" is the reference; "control"
rounds them to float8 (e4m3, one scale per tensor) where the
configuration computes in bfloat16 and to bfloat16 where it computes in
float32, the nearest precision below what the configuration states.

Departures from the published descriptions, each as the program has it:
the Perceive encoders' ProbSparse selection keeps every query whose
sparsity measure ties the u-th largest; the SwinV2 patch merging
concatenates the 2 x 2 neighbours row-major; the ViT has no class token.
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.prng import prob_sparse_index_sample

NEG_INF = -1e30
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def float32_matmuls() -> None:
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` (a float8) with one scale for the tensor
    that maps its largest magnitude to the format's largest finite value."""
    scale = t.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).float() * scale


class _Float8(torch.autograd.Function):
    """Operands rounded to e4m3 in the forward, their gradients to e5m2 in
    the backward, each tensor with its own scale (the usual float8
    training recipe)."""

    @staticmethod
    def forward(ctx, t):
        return _fp8(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    """Rounding of matmul operands (see the module docstring)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "control"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode

    def __call__(self, t: torch.Tensor, low: bool) -> torch.Tensor:
        if self.mode == "f32":
            return t
        if not low:
            return t.to(torch.bfloat16).float()
        return _Float8.apply(t)

    def mm(self, a, b, low: bool):
        return self(a, low) @ self(b, low)


class Draws:
    """The random numbers of one training forward, drawn as the program
    draws them: device draws from the default generator of ``device``,
    per-batch decisions from the CPU's default generator. ``mask_dtype``
    is the dtype of the tensors that the program's decoder layers drop
    out (their compute dtype). With ``on`` False nothing is drawn."""

    def __init__(self, device, mask_dtype, on: bool = True):
        self.device, self.mask_dtype, self.on = torch.device(device), mask_dtype, on

    def randint(self, high: int, shape) -> torch.Tensor:
        return torch.randint(0, high, shape, device=self.device)

    def rand_keep(self, shape, p: float) -> torch.Tensor:
        """A keep-mask as the fused Perceive stack draws it."""
        return (torch.rand(*shape, device=self.device) < 1.0 - p).float()

    def dropout_keep(self, shape, p: float, dtype=None) -> torch.Tensor:
        """The keep-mask of ``F.dropout`` on a fresh contiguous tensor of
        ``shape`` and ``dtype`` (the mask depends on both)."""
        ones = torch.ones(shape, dtype=dtype or self.mask_dtype, device=self.device)
        return (F.dropout(ones, p) != 0).float()

    def decision(self) -> float:
        return float(torch.rand(()))


# ----------------------------------------------------------------- layers #


class Lin(nn.Module):
    """``x W^T + b`` with ``W`` (out, in); ``low`` marks a layer that the
    configuration computes in bfloat16."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True, low: bool = False,
                 prec: Optional[Precision] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None
        self.low, self.prec = low, prec or Precision()

    def forward(self, x):
        y = self.prec.mm(x, self.weight.t(), self.low)
        return y if self.bias is None else y + self.bias


class Conv(nn.Module):
    """A kernel-``k`` convolution over time on ``(B, L, C)`` windows already
    cut (``windows``), as a matmul; its weight is torch's ``(out, in, k)``."""

    def __init__(self, n_in: int, n_out: int, k: int, bias: bool, low: bool, prec):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, k))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None
        self.low, self.prec = low, prec

    def forward(self, windows):  # (B, L', C, k)
        y = self.prec.mm(windows.flatten(2), self.weight.flatten(1).t(), self.low)
        return y if self.bias is None else y + self.bias


def time_windows(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(B, L, C) -> (B, L - k + 1, C, k) sliding windows."""
    length = x.shape[1] - k + 1
    return torch.stack([x[:, i:i + length] for i in range(k)], dim=-1)


class TokenConv(nn.Module):
    """Kernel-3 circular convolution over time (Informer's TokenEmbedding)."""

    def __init__(self, c_in, d_model, bias, low, prec):
        super().__init__()
        self.conv = Conv(c_in, d_model, 3, bias, low, prec)

    def forward(self, x):
        return self.conv(time_windows(torch.cat([x[:, -1:], x, x[:, :1]], dim=1)))


def sinusoid(length: int, d_model: int, device) -> torch.Tensor:
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / d_model))
    pe = torch.zeros(length, d_model, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe[None]


def layer_norm(module: nn.LayerNorm, x):
    return F.layer_norm(x, module.normalized_shape, module.weight, module.bias, module.eps)


def tanh_gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def prob_sparse_sizes(l_q: int, l_k: int, factor: int):
    """(u, u_part): queries kept and keys sampled per query."""
    return (min(int(factor * math.ceil(math.log(l_q))), l_q),
            min(int(factor * math.ceil(math.log(l_k))), l_k))


def eval_sample(l_q: int, u_part: int, l_k: int, device) -> torch.Tensor:
    return torch.from_numpy(prob_sparse_index_sample(l_q, u_part, l_k).astype(np.int64)).to(device)


def counts(index: torch.Tensor, l_k: int) -> torch.Tensor:
    """(..., L_q, U) sampled keys -> (..., L_q, L_k) multiplicities."""
    out = torch.zeros(*index.shape[:-1], l_k, device=index.device)
    return out.scatter_add_(-1, index, torch.ones_like(index, dtype=torch.float32))


def prob_sparse(q, k, v, cnt, *, u: int, causal: bool, prec, low):
    """ProbSparse attention on (B, H, L, E) with key multiplicities ``cnt``
    (L_q, L_k): the measure ``max - sum / L_k`` over each query's sampled
    keys; the queries whose measure is among the ``u`` largest (ties kept)
    attend, the others take the mean of V (the running sum when causal)."""
    l_q, l_k = q.shape[2], k.shape[2]
    qk = prec.mm(q, k.transpose(-1, -2), low)
    sampled_max = torch.where(cnt > 0, qk, torch.full_like(qk, NEG_INF)).amax(-1)
    m = sampled_max - (qk * cnt).sum(-1) / l_k
    selected = (m[..., :, None] < m[..., None, :]).sum(-1) < u
    scores = qk / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones(l_q, l_k, dtype=torch.bool, device=q.device).triu(1)
        scores = scores.masked_fill(mask, NEG_INF)
        context = v.cumsum(2)
    else:
        context = v.mean(2, keepdim=True).expand(*v.shape[:2], l_q, v.shape[-1])
    update = prec.mm(torch.softmax(scores, dim=-1), v, low)
    return torch.where(selected[..., None], update, context)


class AttentionLayer(nn.Module):
    """q/k/v/out projections around ProbSparse (``kind`` "prob") or dense
    softmax attention ("full"); ``mix`` merges heads from the head-major
    layout, as Informer does."""

    def __init__(self, d_model, n_heads, kind, causal, factor, mix, low, prec,
                 attention_dropout=0.0):
        super().__init__()
        for name in ("query_projection", "key_projection", "value_projection",
                     "out_projection"):
            setattr(self, name, Lin(d_model, d_model, True, low, prec))
        self.n_heads, self.kind, self.causal, self.factor = n_heads, kind, causal, factor
        self.mix, self.low, self.prec, self.p = mix, low, prec, attention_dropout

    def forward(self, queries, keys, values, draws: Draws):
        b, l, _ = queries.shape
        s, h = keys.shape[1], self.n_heads
        q = self.query_projection(queries).reshape(b, l, h, -1).transpose(1, 2)
        k = self.key_projection(keys).reshape(b, s, h, -1).transpose(1, 2)
        v = self.value_projection(values).reshape(b, s, h, -1).transpose(1, 2)
        prec = self.prec
        if self.kind == "prob":
            u, u_part = prob_sparse_sizes(l, s, self.factor)
            index = (draws.randint(s, (l, u_part)) if draws.on
                     else eval_sample(l, u_part, s, q.device))
            out = prob_sparse(q, k, v, counts(index, s), u=u, causal=self.causal,
                              prec=prec, low=self.low)
        else:
            weights = torch.softmax(prec.mm(q, k.transpose(-1, -2), self.low)
                                    / math.sqrt(q.shape[-1]), dim=-1)
            if draws.on and self.p > 0.0:
                weights = weights * draws.dropout_keep(weights.shape, self.p,
                                                       torch.float32) / (1.0 - self.p)
            out = prec.mm(weights, v, self.low)
        out = out if self.mix else out.transpose(1, 2)  # mix: (B, H, L, E) merged as is
        return self.out_projection(out.reshape(b, l, -1))


# ------------------------------------------------------- Perceive stacks #


class StackLayer(nn.Module):
    """One Perceive encoder layer: ProbSparse self-attention, dropout,
    LayerNorm, the gelu FFN with dropout on its activation and output,
    LayerNorm (eps 1e-6)."""

    def __init__(self, d, f, heads, low, prec):
        super().__init__()
        self.attention = AttentionLayer(d, heads, "prob", False, 5, False, low, prec)
        self.ff1, self.ff2 = Lin(d, f, True, low, prec), Lin(f, d, True, low, prec)
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=1e-6), nn.LayerNorm(d, eps=1e-6)

    def forward(self, x, cnt, u, masks, keep):
        a = self.attention
        b, l, d = x.shape
        h = a.n_heads
        q, k, v = (proj(x).reshape(b, l, h, -1).transpose(1, 2) for proj in
                   (a.query_projection, a.key_projection, a.value_projection))
        att = prob_sparse(q, k, v, cnt, u=u, causal=False, prec=a.prec, low=a.low)
        new = a.out_projection(att.transpose(1, 2).reshape(b, l, d))
        m1, m2, m3 = masks if masks is not None else (1.0, 1.0, 1.0)
        x = layer_norm(self.norm1, x + new * m1 * keep)
        y = F.gelu(self.ff1(x)) * m2 * keep
        return layer_norm(self.norm2, x + self.ff2(y) * m3 * keep)


class PerceiveEncoder(nn.Module):
    """The Perceive encoder: token convolution and position, N stack
    layers, LayerNorm, projection, the last ``out_len`` tokens. In
    training the key samples of all N layers are drawn first, then the
    three keep-masks of all N layers, as the fused stack draws them."""

    def __init__(self, c_in, c_out, out_len, cfg, prec, d=128):
        super().__init__()
        low = cfg["compute_dtype"] == "bfloat16"
        self.out_len, self.p = out_len, cfg["feature_dropout"]
        self.value_embedding = TokenConv(c_in, d, True, False, prec)
        self.stacked_layers = nn.ModuleList(
            StackLayer(d, cfg["encoder_d_ff"], cfg["encoder_heads"], low, prec)
            for _ in range(cfg["encoder_layers"]))
        self.norm = nn.LayerNorm(d, eps=1e-6)
        self.projection = Lin(d, c_out, True, False, prec)

    def forward(self, x, draws: Draws):
        h = self.value_embedding(x)
        r, l, d = h.shape
        h = h + sinusoid(l, d, h.device)
        n = len(self.stacked_layers)
        u, u_part = prob_sparse_sizes(l, l, 5)
        masks, keep = None, 1.0
        if draws.on:
            cnt = counts(draws.randint(l, (n, l, u_part)), l)
            if self.p > 0.0:
                f = self.stacked_layers[0].ff1.weight.shape[0]
                masks = [draws.rand_keep((n, r, l, w), self.p) for w in (d, f, d)]
                keep = float(np.float32(1.0 / (1.0 - self.p)))
        else:
            cnt = counts(eval_sample(l, u_part, l, h.device), l).expand(n, l, l)
        for i, layer in enumerate(self.stacked_layers):
            h = layer(h, cnt[i], u, None if masks is None else [m[i] for m in masks], keep)
        return self.projection(layer_norm(self.norm, h))[:, -self.out_len:]


class DecoderLayer(nn.Module):
    """Causal ProbSparse self-attention, dense cross-attention with dropout
    on its weights, the gelu FFN; dropout after each; three LayerNorms."""

    def __init__(self, d, f, heads, factor, mix, low, prec, activation, p):
        super().__init__()
        self.self_attention = AttentionLayer(d, heads, "prob", True, factor, mix, low, prec)
        self.cross_attention = (
            AttentionLayer(d, heads, "prob", False, factor, mix, low, prec)
            if activation == "relu" else
            AttentionLayer(d, heads, "full", False, factor, False, low, prec, p))
        self.ff1, self.ff2 = Lin(d, f, True, low, prec), Lin(f, d, True, low, prec)
        for i in (1, 2, 3):
            setattr(self, f"norm{i}", nn.LayerNorm(d, eps=1e-6))
        self.act = F.relu if activation == "relu" else F.gelu
        self.p = p

    def drop(self, x, draws):
        if not (draws.on and self.p > 0.0):
            return x
        return x * draws.dropout_keep(x.shape, self.p) / (1.0 - self.p)

    def forward(self, x, cross, draws):
        x = layer_norm(self.norm1, x + self.drop(self.self_attention(x, x, x, draws), draws))
        x = x + self.drop(self.cross_attention(x, cross, cross, draws), draws)
        x = layer_norm(self.norm2, x)
        y = self.drop(self.act(self.ff1(x)), draws)
        y = self.drop(self.ff2(y), draws)
        return layer_norm(self.norm3, x + y)


class Decoder(nn.Module):
    def __init__(self, layers, d):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(d, eps=1e-6)


class PerceiveDecoder(nn.Module):
    def __init__(self, d, c_out, out_len, cfg, prec):
        super().__init__()
        low = cfg["compute_dtype"] == "bfloat16"
        self.out_len = out_len
        self.value_embedding = TokenConv(d, d, True, False, prec)
        self.decoder = Decoder([DecoderLayer(d, cfg["encoder_d_ff"],
                                             cfg["cross_modal_decoder_heads"], 5, False, low,
                                             prec, "gelu", cfg["feature_dropout"])
                                for _ in range(cfg["cross_modal_decoder_layers"])], d)
        self.projection = Lin(d, c_out, True, False, prec)

    def forward(self, x_enc, x_dec, draws):
        h = self.value_embedding(x_dec)
        h = h + sinusoid(h.shape[1], h.shape[2], h.device)
        for layer in self.decoder.layers:
            h = layer(h, x_enc, draws)
        return self.projection(layer_norm(self.decoder.norm, h))[:, -self.out_len:]


# ---------------------------------------------------------------- Informer #


class EncoderLayer(nn.Module):
    def __init__(self, d, f, heads, factor, prec):
        super().__init__()
        self.attention = AttentionLayer(d, heads, "prob", False, factor, True, False, prec)
        self.ff1, self.ff2 = Lin(d, f, True, False, prec), Lin(f, d, True, False, prec)
        self.norm1, self.norm2 = nn.LayerNorm(d, eps=1e-6), nn.LayerNorm(d, eps=1e-6)

    def forward(self, x, draws):
        x = layer_norm(self.norm1, x + self.attention(x, x, x, draws))
        return layer_norm(self.norm2, x + self.ff2(F.relu(self.ff1(x))))


class ConvLayer(nn.Module):
    """Distillation: circular pad 2, kernel-3 convolution, BatchNorm (batch
    statistics in training), ELU, max-pool 3 with stride 2."""

    def __init__(self, d, prec):
        super().__init__()
        self.conv = Conv(d, d, 3, True, False, prec)
        self.norm = nn.BatchNorm1d(d, eps=1e-5, momentum=0.1)

    def forward(self, x):
        x = self.conv(time_windows(torch.cat([x[:, -2:], x, x[:, :2]], dim=1)))
        x = F.elu(self.norm(x.transpose(1, 2)))
        return F.max_pool1d(x, 3, stride=2, padding=1).transpose(1, 2)


class DataEmbedding(nn.Module):
    def __init__(self, c_in, d, prec):
        super().__init__()
        self.value_embedding = TokenConv(c_in, d, False, False, prec)
        self.temporal_embedding = nn.Module()
        self.temporal_embedding.linear = Lin(1, d, False, False, prec)

    def forward(self, x, marks):
        out = self.value_embedding(x) + self.temporal_embedding.linear(marks)
        return out + sinusoid(x.shape[1], out.shape[2], x.device)


class Informer(nn.Module):
    """Informer with distillation and the smart decoder seed (the last input
    step repeated), f32 in the configuration."""

    def __init__(self, g: dict, c_in: int, c_out: int, prec):
        super().__init__()
        d, f, heads, factor = g["d_model"], g["d_ff"], g["n_heads"], g["factor"]
        self.pred_len = g["pred_len"]
        self.enc_embedding = DataEmbedding(c_in, d, prec)
        self.dec_embedding = DataEmbedding(c_in, d, prec)
        self.encoder = nn.Module()
        self.encoder.attn_layers = nn.ModuleList(
            EncoderLayer(d, f, heads, factor, prec) for _ in range(g["e_layers"]))
        self.encoder.conv_layers = nn.ModuleList(
            ConvLayer(d, prec) for _ in range(g["e_layers"] - 1))
        self.encoder.norm = nn.LayerNorm(d, eps=1e-6)
        self.decoder = Decoder([DecoderLayer(d, f, heads, factor, True, False, prec, "relu", 0.0)
                                for _ in range(g["d_layers"])], d)
        self.decoder.projection = Lin(d, c_out, True, False, prec)

    def forward(self, x, draws):
        b, l, c = x.shape
        marks = torch.arange(l + self.pred_len, dtype=torch.float32, device=x.device)[None, :, None]
        x_dec = torch.cat([x, x[:, -1:].expand(b, self.pred_len, c)], dim=1)
        h = self.enc_embedding(x, marks[:, :l].expand(b, l, 1))
        layers, convs = self.encoder.attn_layers, self.encoder.conv_layers
        for layer, conv in zip(layers, convs):
            h = conv(layer(h, draws))
        enc = layer_norm(self.encoder.norm, layers[-1](h, draws))
        h = self.dec_embedding(x_dec, marks.expand(b, -1, 1))
        for layer in self.decoder.layers:
            h = layer(h, enc, draws)
        h = self.decoder.projection(layer_norm(self.decoder.norm, h))
        return h[:, -self.pred_len:]


# ---------------------------------------------------------- video backbones #


def condition_frames(frames: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (N, H, W, 3) -> [0, 1], zero-padded to a square at the bottom
    and right, resized bilinearly (antialiased) to ``size``, normalised
    by the ImageNet statistics; (N, size, size, 3) f32."""
    x = frames.float() / 255.0
    n, h, w, _ = x.shape
    side = max(h, w)
    x = F.pad(x, (0, 0, 0, side - w, 0, side - h)).permute(0, 3, 1, 2)
    if side != size:
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=True)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=x.device)[:, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """Non-overlapping ``p`` x ``p`` patches of channel-last frames, as a
    matmul with torch's conv weight ``(out, 3, p, p)``."""

    def __init__(self, width, p, prec):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(width, 3, p, p))
        self.bias = nn.Parameter(torch.empty(width))
        self.p, self.prec = p, prec

    def forward(self, x):  # (N, H, W, 3) -> (N, H/p, W/p, width)
        n, h, w, c = x.shape
        p = self.p
        x = x.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4).flatten(3)
        return self.prec.mm(x, self.weight.flatten(1).t(), True) + self.bias


def relative_tables(window: int):
    coords = np.arange(-(window - 1), window, dtype=np.float64)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1) / (window - 1)
    table = np.sign(table) * np.log2(np.abs(table) * 8 + 1.0) / np.log2(8)
    grid = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = grid.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (window - 1)
    index = rel[..., 0] * (2 * window - 1) + rel[..., 1]
    return (torch.from_numpy(table.reshape(-1, 2).astype(np.float32)),
            torch.from_numpy(index.astype(np.int64)))


def shift_mask(h: int, w: int, window: int, shift: int) -> torch.Tensor:
    """(nW, n, n): -100 between tokens of different regions of a rolled map."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(h // window, window, w // window, window).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, window * window)
    return torch.from_numpy(np.where(wins[:, None, :] != wins[:, :, None], -100.0, 0.0)
                            .astype(np.float32))


class SwinAttention(nn.Module):
    def __init__(self, dim, window, heads, prec):
        super().__init__()
        self.qkv = Lin(dim, 3 * dim, False, True, prec)
        self.q_bias, self.v_bias = nn.Parameter(torch.empty(dim)), nn.Parameter(torch.empty(dim))
        self.proj = Lin(dim, dim, True, True, prec)
        self.logit_scale = nn.Parameter(torch.empty(heads, 1, 1))
        self.cpb_fc1 = Lin(2, 512, True, False, prec)
        self.cpb_fc2 = Lin(512, heads, False, False, prec)
        self.window, self.heads, self.prec = window, heads, prec

    def forward(self, x, mask):
        """x (B_w, n, C) window rows; mask (nW, n, n) or None."""
        b, n, c = x.shape
        h = self.heads
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = (self.qkv(x) + bias).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = F.normalize(qkv[0], dim=-1), F.normalize(qkv[1], dim=-1), qkv[2]
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        s = self.prec.mm(q, k.transpose(-1, -2), True) * scale
        table, index = relative_tables(self.window)
        cpb = self.cpb_fc2(F.relu(self.cpb_fc1(table.to(x.device))))
        s = s + 16.0 * torch.sigmoid(cpb[index.reshape(-1)].reshape(n, n, h).permute(2, 0, 1))
        if mask is not None:
            nw = mask.shape[0]
            s = (s.reshape(b // nw, nw, h, n, n) + mask.to(x.device)[None, :, None]).flatten(0, 1)
        out = self.prec.mm(torch.softmax(s, dim=-1), v, True)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class SwinBlock(nn.Module):
    """Res-post-norm SwinV2 block: ``x + LN1(attn(x))``,
    ``x + LN2(fc2(gelu(fc1(x))))``, windows shifted by ``shift``."""

    def __init__(self, dim, heads, window, shift, hw, gelu, prec):
        super().__init__()
        self.window = min(window, hw)
        self.shift = shift if self.window < hw else 0
        self.attn = SwinAttention(dim, self.window, heads, prec)
        self.norm1, self.norm2 = nn.LayerNorm(dim, eps=1e-5), nn.LayerNorm(dim, eps=1e-5)
        self.fc1, self.fc2 = Lin(dim, 4 * dim, True, True, prec), Lin(4 * dim, dim, True, True, prec)
        self.gelu = tanh_gelu if gelu == "tanh" else F.gelu
        self.hw = hw

    def forward(self, x):
        n, h, w, c = x.shape
        ws, s = self.window, self.shift
        y = torch.roll(x, (-s, -s), dims=(1, 2)) if s else x
        y = y.reshape(n, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        y = self.attn(y, shift_mask(h, w, ws, s) if s else None)
        y = y.reshape(n, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, c)
        y = torch.roll(y, (s, s), dims=(1, 2)) if s else y
        x = x + layer_norm(self.norm1, y)
        return x + layer_norm(self.norm2, self.fc2(self.gelu(self.fc1(x))))


class SwinV2(nn.Module):
    """SwinV2: patch embedding and LayerNorm, stages of block pairs (the
    second of each pair shifted by half a window), patch merging between
    stages, final LayerNorm; (N, H/32, W/32, 8 C) features."""

    def __init__(self, v: dict, prec):
        super().__init__()
        self.img_size = v["img_size"]
        dim, hw = v["embed_dim"], v["img_size"] // v["patch_size"]
        self.patch_embed = PatchEmbed(dim, v["patch_size"], prec)
        self.patch_norm = nn.LayerNorm(dim, eps=1e-5)
        self.stages = nn.ModuleList()
        self.merges = nn.ModuleDict()
        for si, (depth, heads) in enumerate(zip(v["depths"], v["heads"])):
            stage = nn.Module()
            shift = min(v["window"], hw) // 2
            stage.pairs = nn.ModuleList()
            for _ in range(depth // 2):
                pair = nn.Module()
                pair.block_a = SwinBlock(dim, heads, v["window"], 0, hw, v["gelu"], prec)
                pair.block_b = SwinBlock(dim, heads, v["window"], shift, hw, v["gelu"], prec)
                stage.pairs.append(pair)
            self.stages.append(stage)
            if si < len(v["depths"]) - 1:
                merge = nn.Module()
                merge.reduction = Lin(4 * dim, 2 * dim, False, True, prec)
                merge.norm = nn.LayerNorm(2 * dim, eps=1e-5)
                self.merges[str(si)] = merge
                dim, hw = dim * 2, hw // 2
        self.final_norm = nn.LayerNorm(dim, eps=1e-5)
        self.feature_dim = dim

    def forward(self, frames):
        x = layer_norm(self.patch_norm, self.patch_embed(condition_frames(frames, self.img_size)))
        for si, stage in enumerate(self.stages):
            for pair in stage.pairs:
                x = pair.block_b(pair.block_a(x))
            if str(si) in self.merges:
                m = self.merges[str(si)]
                n, h, w, c = x.shape
                x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
                x = layer_norm(m.norm, m.reduction(x.reshape(n, h // 2, w // 2, 4 * c)))
        return layer_norm(self.final_norm, x)


class ViTBlock(nn.Module):
    def __init__(self, width, heads, prec):
        super().__init__()
        self.norm1, self.norm2 = nn.LayerNorm(width, eps=1e-6), nn.LayerNorm(width, eps=1e-6)
        self.qkv = Lin(width, 3 * width, True, True, prec)
        self.proj = Lin(width, width, True, True, prec)
        self.fc1, self.fc2 = Lin(width, 4 * width, True, True, prec), Lin(4 * width, width, True, True, prec)
        self.heads, self.prec = heads, prec

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(layer_norm(self.norm1, x)).reshape(b, n, 3, self.heads, -1)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        s = self.prec.mm(q, k.transpose(-1, -2), True) / math.sqrt(q.shape[-1])
        attn = self.prec.mm(torch.softmax(s, dim=-1), v, True)
        x = x + self.proj(attn.transpose(1, 2).reshape(b, n, c))
        return x + self.fc2(F.gelu(self.fc1(layer_norm(self.norm2, x))))


class ViT(nn.Module):
    """Pre-norm ViT without a class token (DinoV2's ViT-B/14 at 518 px as
    the port runs it): patches plus a learned position embedding, the
    blocks, final LayerNorm; (N, grid, grid, width) features."""

    def __init__(self, v: dict, prec):
        super().__init__()
        self.img_size = v["img_size"]
        self.grid = v["img_size"] // v["patch_size"]
        self.patch_embed = PatchEmbed(v["width"], v["patch_size"], prec)
        self.pos_embed = nn.Parameter(torch.empty(1, self.grid ** 2, v["width"]))
        self.blocks = nn.ModuleList(ViTBlock(v["width"], v["heads"], prec)
                                    for _ in range(v["depth"]))
        self.norm = nn.LayerNorm(v["width"], eps=1e-6)
        self.feature_dim = v["width"]

    def forward(self, frames):
        x = self.patch_embed(condition_frames(frames, self.img_size))
        n = x.shape[0]
        x = x.reshape(n, self.grid ** 2, -1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return layer_norm(self.norm, x).reshape(n, self.grid, self.grid, -1)


# ----------------------------------------------------------------- the model #


def fps_indices(length: int, step: int) -> torch.Tensor:
    """Every ``step``-th frame counting back from the last."""
    return torch.arange(length - 1, 0, -step).flip(0)


def median_downsample(x: torch.Tensor, target: int) -> torch.Tensor:
    """Lower median of each ``T // target`` window (trailing samples dropped)."""
    b, t, c = x.shape
    stride = t // target
    windows = x[:, :target * stride].reshape(b, target, stride, c)
    return torch.sort(windows, dim=2).values[:, :, (stride - 1) // 2]


class Routeformer(nn.Module):
    """Routeformer with video and gaze and dense prediction: motion
    features from GPS steps; left, right and front frames through the
    video backbone and the frame encoder; the gaze encoder and the
    gaze-video decoder; the video encoder over the views' timelines; the
    Informer; the trajectory integrated onto the last GPS fix.

    ``config`` is the benchmark's configuration file (``model``,
    ``gps_backbone``, ``video_backbone``). ``frame_chunk`` frames go
    through the backbone at a time, which is frozen (no autograd)."""

    def __init__(self, config: dict, precision: str = "f32", frame_chunk: int = 32):
        super().__init__()
        cfg, g, v = config["model"], config["gps_backbone"], config["video_backbone"]
        self.cfg, self.frame_chunk = cfg, frame_chunk
        prec = Precision(precision)
        self.mask_dtype = torch.bfloat16 if cfg["compute_dtype"] == "bfloat16" else torch.float32
        self.video_backbone = SwinV2(v, prec) if v["kind"] == "swinv2" else ViT(v, prec)
        emb, hidden, seq_len = cfg["image_embedding_size"], cfg["encoder_hidden_size"], g["seq_len"]
        self.frame_encoder = PerceiveEncoder(self.video_backbone.feature_dim, emb, 1, cfg, prec)
        for name in ("left_video_embedding", "right_video_embedding", "gaze_video_embedding",
                     "video_output_embedding"):
            setattr(self, name, nn.Parameter(torch.empty(1, 1, emb)))
        self.video_encoder = PerceiveEncoder(emb, hidden, seq_len, cfg, prec)
        self.gaze_encoder = PerceiveEncoder(2, hidden, seq_len, cfg, prec)
        self.gaze_video_decoder = PerceiveDecoder(hidden, hidden, seq_len, cfg, prec)
        c_in = 5 + hidden
        self.gps_backbone = Informer(g, c_in, c_in - 3, prec)
        self.seq_len = seq_len

    def draws(self, device, on: bool) -> Draws:
        return Draws(device, self.mask_dtype, on)

    def encode_frames(self, streams, draws):
        """Pixel streams -> per-stream (N_i, emb): the backbone in chunks
        without autograd, then one frame-encoder call over all streams,
        each map followed by a token of -1."""
        sizes = [s.shape[0] for s in streams]
        with torch.no_grad():
            maps = torch.cat([self.video_backbone(s[i:i + self.frame_chunk]) for s in streams
                              for i in range(0, s.shape[0], self.frame_chunk)])
        tokens = maps.reshape(maps.shape[0], -1, maps.shape[-1])
        tokens = torch.cat([tokens, -torch.ones_like(tokens[:, :1])], dim=1)
        encoded = self.frame_encoder(tokens, draws).reshape(-1, self.cfg["image_embedding_size"])
        return torch.split(encoded, sizes)

    @staticmethod
    def timeline(feats, b, length, idx):
        feats = feats.reshape(b, -1, feats.shape[-1])
        full = feats.new_zeros(b, length, feats.shape[-1])
        full[:, idx.to(feats.device)] = feats
        return full

    def preprocess(self, batch, draws: Draws, decisions: bool):
        """(motion_dynamics, visual features); ``decisions`` draws view
        and gaze dropout, ``draws`` the layers' random numbers."""
        cfg = self.cfg
        gps = batch["gps"].float()
        if cfg["motion_noise"] > 0.0 and decisions:
            gps = gps + torch.randn_like(gps) * cfg["motion_noise"]
        motion = F.pad(gps[:, 1:] - gps[:, :-1], (0, 0, 1, 0))
        drop_left = drop_right = False
        if decisions and cfg["view_dropout"] > 0.0 and draws.decision() < cfg["view_dropout"]:
            drop_left = draws.decision() < 0.5
            drop_right = not drop_left
        left, right, front = batch["left_video"], batch["right_video"], batch["front_video"]
        b, t = left.shape[:2]
        idx = fps_indices(t, cfg["output_fps"] // cfg["video_fps"])
        fidx = fps_indices(front.shape[1], cfg["output_fps"] // cfg["gaze_fps"])
        streams = [left[:, idx].flatten(0, 1), right[:, idx].flatten(0, 1),
                   front[:, fidx].flatten(0, 1)]
        left_f, right_f, front_f = self.encode_frames(streams, draws)
        if drop_left:
            left_f = torch.zeros_like(left_f)
        if drop_right:
            right_f = torch.zeros_like(right_f)
        visual = [self.timeline(left_f, b, t, idx) + self.left_video_embedding,
                  self.timeline(right_f, b, t, idx) + self.right_video_embedding]
        gaze_video = self.timeline(front_f, b, front.shape[1], fidx)
        gaze = self.gaze_encoder(median_downsample(batch["gaze"].float(), self.seq_len), draws)
        gaze_features = self.gaze_video_decoder(gaze_video, gaze, draws)[:, :gaze_video.shape[1]]
        if decisions and cfg["gaze_dropout"] > 0.0 and draws.decision() < cfg["gaze_dropout"]:
            gaze_features = torch.zeros_like(gaze_features)
        visual.append(gaze_features + self.gaze_video_embedding)
        visual.append(torch.zeros_like(visual[-1]) + self.video_output_embedding)
        return motion, self.video_encoder(torch.cat(visual, dim=1), draws)

    def forward(self, batch, draws: Draws, decisions: bool):
        """(future gps (B, pred_len, 2), dense features (B, pred_len, emb))."""
        motion, visual = self.preprocess(batch, draws, decisions)
        angle = torch.atan2(motion[..., 1], motion[..., 0])[..., None]
        norm = torch.linalg.vector_norm(motion, dim=-1)[..., None]
        accel = F.pad(norm[:, 1:] - norm[:, :-1], (0, 0, 1, 0))
        x = torch.cat([motion, (angle - angle[:, :1]) / math.pi, norm, accel, visual], dim=-1)
        out = self.gps_backbone(x, draws)
        future = batch["gps"][:, -1:].float() + torch.cumsum(out[..., :2], dim=1)
        return future, out[..., 2:2 + self.cfg["image_embedding_size"]]
