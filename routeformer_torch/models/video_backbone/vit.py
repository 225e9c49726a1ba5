"""Vision-transformer video backbones (counterpart of
``routeformer_tpu/models/video_backbone/vit.py``): ``TimmBackbone`` and its
``DinoV2`` and ``Sam`` classes, one ViT with per-preset geometry.

Frames are conditioned as the SwinV2 backbone does (``ops/image.py``
``condition_frames``), patch-embedded, run through ``depth`` pre-norm
blocks and a final LayerNorm in f32, and returned as an
``(N, grid, grid, width)`` map. With ``compute_dtype="bfloat16"`` the patch
embedding and the Linear layers compute in bf16 (parameters stay f32) and
the residual stream is bf16; LayerNorms compute in f32, as flax promotes
them. The blocks' attention is ``ops/attention.py``
``dot_product_attention``, which takes K4 at 512 tokens or more (DinoV2 at
518 px: 1369). The JAX package scans its stacked blocks; here they are a
``ModuleList`` named ``blocks`` (``convert.py`` unstacks the weights).

Backbone training (``train_backbone``): training frames go through the
photometric augment before the normalisation (``swin.augment_frames``),
and ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant): K4's forward runs again there,
its backward a plain recompute.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from routeformer_torch.models.layers.attention import Linear
from routeformer_torch.models.video_backbone.config import TimmBackboneConfig, VideoBackboneModule
from routeformer_torch.models.video_backbone.swin import PatchEmbed, augment_frames
from routeformer_torch.ops.attention import dot_product_attention
from routeformer_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD, condition_frames

LN_EPS = 1e-6  # nnx.LayerNorm's default epsilon


@dataclass(frozen=True)
class ViTPreset:
    img_size: int
    patch_size: int
    width: int
    depth: int
    heads: int
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD


# The JAX package's presets: DinoV2 ViT-B/14 at 518 px (37 x 37 patches) and
# at 224, SAM ViT-B/16, the ViT-class SwinV2 stand-in, and a test size.
PRESETS = {
    "swinv2_base": ViTPreset(img_size=256, patch_size=16, width=768, depth=12, heads=12),
    "dinov2_base": ViTPreset(img_size=518, patch_size=14, width=768, depth=12, heads=12),
    "dinov2_base_224": ViTPreset(img_size=224, patch_size=14, width=768, depth=12, heads=12),
    "samvit_base": ViTPreset(img_size=224, patch_size=16, width=768, depth=12, heads=12),
    "vit_tiny_test": ViTPreset(img_size=64, patch_size=16, width=32, depth=2, heads=4),
}


def resolve_preset(model_type: Optional[str]) -> str:
    """A preset name, or a timm model string mapped as the JAX package does
    ("swin", "dino", "sam")."""
    name = model_type or "vit_tiny_test"
    if name in PRESETS:
        return name
    lowered = name.lower()
    for tag, preset in (("swin", "swinv2_base"), ("dino", "dinov2_base"),
                        ("sam", "samvit_base")):
        if tag in lowered:
            return preset
    raise ValueError(f"Unknown video backbone model_type {name!r}")


class ViTBlock(nn.Module):
    """Pre-norm block: ``x + proj(attn(norm1 x))``, ``x + fc2(gelu(fc1(norm2 x)))``."""

    mesh_gather_unit = True  # a mesh gathers the block's weights together
    mesh_split_pairs = (("fc1", "fc2"),)  # fc1 -> gelu -> fc2

    def __init__(self, width: int, heads: int, compute_dtype: Optional[torch.dtype] = None,
                 gelu_approximate: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.qkv = Linear(width, 3 * width, compute_dtype=compute_dtype)
        self.proj = Linear(width, width, compute_dtype=compute_dtype)
        self.fc1 = Linear(width, 4 * width, compute_dtype=compute_dtype)
        self.fc2 = Linear(4 * width, width, compute_dtype=compute_dtype)
        self.heads = heads
        self.gelu = "tanh" if gelu_approximate else "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(self.norm1(x.float())).reshape(b, n, 3, self.heads, c // self.heads)
        attn = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        x = x + self.proj(attn.reshape(b, n, c))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x.float())), approximate=self.gelu))


class TimmBackbone(VideoBackboneModule):
    """ViT image encoder with the reference's input conditioning."""

    epoch_unfreeze = True  # the trainer's epoch-10 flip sets ``unfreeze``

    def __init__(self, configs: Optional[TimmBackboneConfig] = None):
        super().__init__()
        configs = configs or TimmBackboneConfig()
        self.configs = configs
        self.preset = p = PRESETS[resolve_preset(configs.model_type)]
        self.compute_dtype = torch.bfloat16 if configs.compute_dtype == "bfloat16" else None
        grid = p.img_size // p.patch_size
        self.patch_embed = PatchEmbed(3, p.width, p.patch_size, stride=p.patch_size)
        self.pos_embed = nn.Parameter(torch.randn(1, grid * grid, p.width) * 0.02)
        self.blocks = nn.ModuleList(
            ViTBlock(p.width, p.heads, self.compute_dtype, configs.gelu == "tanh")
            for _ in range(p.depth)
        )
        self.norm = nn.LayerNorm(p.width, eps=LN_EPS)
        self.output_feature_shape = (grid, grid, p.width)
        # The trainer's epoch-10 flip: the model then differentiates
        # through the backbone.
        self.unfreeze = False

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """Pad to square, resize to the native size, normalise."""
        p = self.preset
        return condition_frames(images, p.img_size, p.mean, p.std,
                                pad_to_square=self.configs.pad_to_square)

    def preprocess_frames(self, images: torch.Tensor) -> torch.Tensor:
        """The augment (training with ``train_backbone``), then
        ``preprocess`` and the compute dtype."""
        x = self.preprocess(augment_frames(self, images))
        return x.to(self.compute_dtype) if self.compute_dtype is not None else x

    def encode_frames(self, x: torch.Tensor) -> torch.Tensor:
        """Encoder over preprocessed (N, S, S, C) frames -> (N, H', W', C')."""
        dt = self.compute_dtype or torch.float32
        x = self.patch_embed(x, dt)
        n, c, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2) + self.pos_embed.to(dt)
        remat = self.configs.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.norm(x.float()).reshape(n, gh, gw, c)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) frames -> (N, H', W', C') features."""
        return self.encode_frames(self.preprocess_frames(images))


class DinoV2(TimmBackbone):
    """DinoV2-class encoder (reference video_backbone/__init__.py:21-25)."""


class Sam(TimmBackbone):
    """SAM-ViT-class encoder (reference video_backbone/__init__.py:28-31)."""
