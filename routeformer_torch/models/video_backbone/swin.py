"""SwinV2 vision backbone (counterpart of
``routeformer_tpu/models/video_backbone/swin.py``).

Hierarchical stages of window attention blocks (alternating shifted
windows), patch merging between stages, res-post-norm, cosine attention
with a clamped learnable temperature and the continuous log-spaced
position-bias MLP. Video frames are channel-last ``(N, H, W, C)``.

Blocks with the tanh gelu run the fused block (K1,
``ops/swin_block_fusion.py``) on every stage; blocks with the exact gelu
run window attention (K2, ``ops/flash_attention.py``) with plain Linear and
LayerNorm layers. The JAX package's TPU-only gates (the batch-8 bad-frame
guard and the C <= 512 VMEM gate of the fused block) are not carried over.
Parameter names follow the flax paths; a scanned stage's pairs are a
``ModuleList``.

Backbone training (``train_backbone``): training frames go through the
photometric augment (``ops/augment.py``) in [0, 1], before the
normalisation; ``remat`` recomputes each block pair in the backward
(``torch.utils.checkpoint``, non-reentrant), so the pair's kernels run
again there.
"""

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from routeformer_torch.models.layers.attention import Linear
from routeformer_torch.models.video_backbone.config import TimmBackboneConfig, VideoBackboneModule
from routeformer_torch.ops.flash_attention import flash_window_attention
from routeformer_torch.ops import augment
from routeformer_torch.ops.image import condition_frames, to_float16
from routeformer_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD  # noqa: F401  (as in JAX)
from routeformer_torch.ops.swin_block_fusion import fused_swin_block
from routeformer_torch.ops.weight_cache import derived

LN_EPS = 1e-5  # timm/torch SwinV2 LayerNorm eps


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(N, H, W, C) -> (N * nH * nW, window * window, C)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    n = windows.shape[0] // ((h // window) * (w // window))
    x = windows.reshape(n, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, -1)


def relative_coords_table(window: int) -> np.ndarray:
    coords = np.arange(-(window - 1), window, dtype=np.float64)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1)
    table = table / (window - 1)
    table = np.sign(table) * np.log2(np.abs(table) * 8 + 1.0) / np.log2(8)
    return table.reshape(-1, 2).astype(np.float32)


def relative_position_index(window: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, n, n) additive mask (-100) isolating the wrapped regions."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = (
        img.reshape(h // window, window, w // window, window)
        .transpose(0, 2, 1, 3)
        .reshape(-1, window * window)
    )
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """SwinV2 cosine window attention with a CPB-MLP relative bias."""

    def __init__(self, dim: int, window: int, n_heads: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dim, self.window, self.n_heads = dim, window, n_heads
        self.compute_dtype = compute_dtype
        self.qkv = Linear(dim, 3 * dim, bias=False, compute_dtype=compute_dtype)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = Linear(dim, dim, compute_dtype=compute_dtype)
        self.logit_scale = nn.Parameter(torch.full((n_heads, 1, 1), math.log(10.0)))
        self.cpb_fc1 = nn.Linear(2, 512)
        self.cpb_fc2 = nn.Linear(512, n_heads, bias=False)
        self.register_buffer(
            "coords_table", torch.from_numpy(relative_coords_table(window)),
            persistent=False,
        )
        self.register_buffer(
            "rel_index", torch.from_numpy(relative_position_index(window)),
            persistent=False,
        )

    def get_bias(self) -> torch.Tensor:
        """(H, n, n) continuous position bias, 16 * sigmoid, f32."""
        n = self.window * self.window
        table = self.cpb_fc2(F.relu(self.cpb_fc1(self.coords_table)))
        bias = table[self.rel_index.reshape(-1)].reshape(n, n, self.n_heads)
        return 16.0 * torch.sigmoid(bias.permute(2, 0, 1))

    def qkv_bias(self) -> torch.Tensor:
        return torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])

    def scale(self) -> torch.Tensor:
        """Per-head temperature: exp of the logit scale clamped at log 100."""
        return torch.exp(
            torch.clamp(self.logit_scale, max=math.log(100.0))
        ).reshape(self.n_heads)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B_w, n, C) window rows; mask: (nW, n, n) additive or None."""
        b, n, c = x.shape
        h = self.n_heads
        qkv = self.qkv(x) + self.qkv_bias()  # f32, as in the JAX package
        if self.compute_dtype is not None:
            qkv = qkv.to(self.compute_dtype)
        qkv = qkv.reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        bias = self.get_bias()[None]
        if mask is not None:
            bias = bias + mask[:, None]
        out = flash_window_attention(qkv[0], qkv[1], qkv[2], bias.contiguous(),
                                     self.scale().float().contiguous(), cosine=True)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class SwinBlock(nn.Module):
    """SwinV2 block: res-post-norm window attention + MLP."""

    mesh_split_pairs = (("fc1", "fc2"),)  # fc1 -> gelu -> fc2 (the unfused block)

    def __init__(self, dim: int, n_heads: int, window: int, shift: int,
                 input_hw: Tuple[int, int], compute_dtype=None,
                 gelu_approximate: bool = False):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        self.window = min(window, *input_hw)
        self.shift = shift if self.window < min(input_hw) else 0
        self.compute_dtype = compute_dtype
        self.attn = WindowAttention(dim, self.window, n_heads, compute_dtype)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = Linear(dim, 4 * dim, compute_dtype=compute_dtype)
        self.fc2 = Linear(4 * dim, dim, compute_dtype=compute_dtype)
        mask = (
            torch.from_numpy(shift_attn_mask(*input_hw, self.window, self.shift))
            if self.shift > 0 else None
        )
        self.register_buffer("attn_mask", mask, persistent=False)

    def _partition(self, x):
        if self.shift > 0:
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
        return window_partition(x, self.window)

    def _reverse(self, wins, h, w):
        x = window_reverse(wins, self.window, h, w)
        if self.shift > 0:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        return x

    def fused_params(self) -> dict:
        """The fused block's parameters; the qkv bias and the logit scale
        are derived once and reused until their sources change
        (``derived``)."""
        a = self.attn
        return {
            "wqkv": a.qkv.weight,
            "bqkv": derived("qkv_bias", lambda *_: a.qkv_bias(), a.q_bias, a.v_bias),
            "wproj": a.proj.weight, "bproj": a.proj.bias,
            "ln1_scale": self.norm1.weight, "ln1_bias": self.norm1.bias,
            "wfc1": self.fc1.weight, "bfc1": self.fc1.bias,
            "wfc2": self.fc2.weight, "bfc2": self.fc2.bias,
            "ln2_scale": self.norm2.weight, "ln2_bias": self.norm2.bias,
            "logit_scale": derived("logit_scale", lambda _: a.scale(), a.logit_scale),
        }

    def fused_bias(self) -> torch.Tensor:
        """The CPB position bias, plus the shift mask per window kind in a
        shifted block (``derived``, as ``fused_params``)."""
        a = self.attn

        def make(*_):
            bias = a.get_bias()
            if self.attn_mask is not None:
                bias = bias[None] + self.attn_mask[:, None]
            return bias.contiguous()

        sources = (a.cpb_fc1.weight, a.cpb_fc1.bias, a.cpb_fc2.weight)
        if self.attn_mask is not None:
            sources += (self.attn_mask,)
        return derived("swin_bias", make, *sources)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (N, H, W, C)."""
        n, h, w, c = x.shape
        if self.gelu_approximate:
            bias = self.fused_bias()
            out = fused_swin_block(
                self._partition(x), self.fused_params(), bias,
                self.attn.n_heads, self.compute_dtype == torch.bfloat16,
            )
            return self._reverse(out, h, w)
        shortcut = x
        wins = self.attn(self._partition(x), self.attn_mask)
        x = self._reverse(wins, h, w)
        x = shortcut + self.norm1(x.float()).to(shortcut.dtype)
        y = self.fc2(F.gelu(self.fc1(x)))
        return x + self.norm2(y.float()).to(x.dtype)


class SwinBlockPair(nn.Module):
    """One W-MSA + SW-MSA block pair."""

    mesh_gather_unit = True  # a mesh gathers the pair's weights together

    def __init__(self, dim, n_heads, window, input_hw, compute_dtype=None,
                 gelu_approximate=False):
        super().__init__()
        shift = min(window, *input_hw) // 2
        self.block_a = SwinBlock(dim, n_heads, window, 0, input_hw,
                                 compute_dtype, gelu_approximate)
        self.block_b = SwinBlock(dim, n_heads, window, shift, input_hw,
                                 compute_dtype, gelu_approximate)

    def mesh_whole_weights(self) -> bool:
        """K1 (the tanh blocks) takes the pair's whole weights; the unfused
        blocks' Linear layers split on a mesh (qkv gathered before K2)."""
        return self.block_a.gelu_approximate

    def forward(self, x):
        return self.block_b(self.block_a(x))


class SwinStage(nn.Module):
    def __init__(self, dim, n_heads, window, depth, input_hw, compute_dtype=None,
                 gelu_approximate=False):
        super().__init__()
        if depth % 2 != 0:
            raise ValueError(f"Swin stage depth must be even, got {depth}")
        self.pairs = nn.ModuleList(
            SwinBlockPair(dim, n_heads, window, input_hw, compute_dtype,
                          gelu_approximate)
            for _ in range(depth // 2)
        )

    def forward(self, x, remat=False):
        for pair in self.pairs:
            x = checkpoint(pair, x, use_reentrant=False) if remat else pair(x)
        return x


class PatchEmbed(nn.Conv2d):
    """The patch embedding: a strided convolution of channel-last frames in
    ``dtype`` (its weights cast to it), NCHW out. A module call of its own,
    so that a mesh gathers its weight around it (``parallel/mesh.py``)."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.conv2d(x.to(dtype).permute(0, 3, 1, 2), self.weight.to(dtype),
                        self.bias.to(dtype), stride=self.stride)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, compute_dtype=None):
        super().__init__()
        self.reduction = Linear(4 * dim, 2 * dim, bias=False,
                                compute_dtype=compute_dtype)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x):
        n, h, w, c = x.shape
        x = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        x = self.reduction(x.reshape(n, h // 2, w // 2, 4 * c))
        return self.norm(x.float()).to(x.dtype)


@dataclass(frozen=True)
class SwinPreset:
    img_size: int = 256
    patch_size: int = 4
    embed_dim: int = 128
    depths: Sequence[int] = (2, 2, 18, 2)
    heads: Sequence[int] = (4, 8, 16, 32)
    window: int = 16


SWIN_PRESETS = {
    "swinv2_base": SwinPreset(),
    "swinv2_base_192": SwinPreset(img_size=192, window=12),
    "swinv2_tiny_test": SwinPreset(img_size=32, patch_size=4, embed_dim=16,
                                   depths=(2, 2), heads=(2, 4), window=4),
    "swinv2_parity_test": SwinPreset(img_size=64, patch_size=4, embed_dim=16,
                                     depths=(2, 2), heads=(2, 4), window=4),
}


def resolve_preset(model_type: Optional[str]) -> SwinPreset:
    lowered = (model_type or "swinv2_base").lower()
    if lowered in SWIN_PRESETS:
        return SWIN_PRESETS[lowered]
    if "tiny_test" in lowered:
        return SWIN_PRESETS["swinv2_tiny_test"]
    if "192" in lowered and "256" not in lowered:
        return SWIN_PRESETS["swinv2_base_192"]
    return SWIN_PRESETS["swinv2_base"]


def augment_frames(backbone: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The photometric augment of a training backbone's [0, 1] frames,
    gated on ``train_backbone`` and training mode, never on ``unfreeze``
    alone (the reference's gate). Its draws come from the frames' device's
    default generator, which snapshots save and the mesh reseeds per data
    shard."""
    if not (backbone.configs.train_backbone and backbone.training):
        return images
    if images.dtype == torch.uint8:
        images = to_float16(images)
    return augment.photometric_augment(images)


class SwinV2Backbone(VideoBackboneModule):
    """Hierarchical SwinV2 encoder producing a (H/32, W/32, 8*embed) map."""

    epoch_unfreeze = True  # the trainer's epoch-10 flip sets ``unfreeze``

    def __init__(self, configs: Optional[TimmBackboneConfig] = None):
        super().__init__()
        configs = configs or TimmBackboneConfig()
        self.configs = configs
        self.preset = p = resolve_preset(configs.model_type)
        dt = torch.bfloat16 if configs.compute_dtype == "bfloat16" else None
        self.compute_dtype = dt
        gelu_tanh = configs.gelu == "tanh"
        self.patch_embed = PatchEmbed(3, p.embed_dim, p.patch_size, stride=p.patch_size)
        self.patch_norm = nn.LayerNorm(p.embed_dim, eps=LN_EPS)
        hw, dim = p.img_size // p.patch_size, p.embed_dim
        self.stages = nn.ModuleList()
        self.merges = nn.ModuleDict()
        for si, (depth, heads) in enumerate(zip(p.depths, p.heads)):
            self.stages.append(
                SwinStage(dim, heads, p.window, depth, (hw, hw), dt, gelu_tanh)
            )
            if si < len(p.depths) - 1:
                self.merges[str(si)] = PatchMerging(dim, dt)
                dim *= 2
                hw //= 2
        self.final_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.output_feature_shape = (hw, hw, dim)
        # The trainer's epoch-10 flip: the model then differentiates
        # through the backbone (K1/K2 carry gradients).
        self.unfreeze = False

    def preprocess_frames(self, images: torch.Tensor) -> torch.Tensor:
        """The augment (training with ``train_backbone``), then
        ``condition_frames`` to the native size (ImageNet statistics) and
        the compute dtype."""
        images = augment_frames(self, images)
        x = condition_frames(images, self.preset.img_size,
                             pad_to_square=self.configs.pad_to_square)
        return x.to(self.compute_dtype) if self.compute_dtype is not None else x

    def encode_frames(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or x.dtype
        x = self.patch_embed(x, dt).permute(0, 2, 3, 1)
        x = self.patch_norm(x.float()).to(x.dtype)
        remat = self.configs.remat and torch.is_grad_enabled()
        for si, stage in enumerate(self.stages):
            x = stage(x, remat)
            if str(si) in self.merges:
                x = self.merges[str(si)](x)
        return self.final_norm(x.float())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.encode_frames(self.preprocess_frames(images))


class SwinV2(SwinV2Backbone):
    """The flagship's SwinV2 encoder under a class of its own (the JAX
    package's subclass, which keeps its embedding-cache keys apart)."""
