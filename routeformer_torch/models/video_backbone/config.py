"""Video backbone configs (the port's copy of
``routeformer_tpu/models/video_backbone/config.py``): ``VideoBackboneConfig``
(the embedding cache's knobs and ``train_backbone``),
``TimmBackboneConfig`` for the SwinV2 and ViT encoders and
``InverseFormBackboneConfig`` for the HRNet-16 trunk.

``train_backbone`` trains the backbone with the model: its forward keeps
autograd, the photometric augment (``ops/augment.py``) runs on training
frames, and ``remat`` recomputes each encoder block (a SwinV2 block pair,
a ViT block) in the backward instead of storing its activations. It
excludes the embedding cache, whose features would go stale.
"""

from dataclasses import dataclass
from typing import Optional

import torch.nn as nn

from routeformer_torch.utils.config import BaseConfig


class VideoBackboneModule(nn.Module):
    """The video backbones' base: a flattened channel-last frame batch
    ``(N, H, W, C)`` in, a feature map ``(N, H', W', C')`` out, with
    ``output_feature_shape`` ``(H', W', C')`` set by each backbone.
    ``epoch_unfreeze``: whether the trainer's epoch-10 boundary flips the
    backbone's ``unfreeze`` (the timm encoders opt in)."""

    epoch_unfreeze = False


@dataclass
class VideoBackboneConfig(BaseConfig):
    cache_dir: Optional[str] = None
    train_backbone: bool = False
    cache_enabled: bool = False
    # The embedding cache's knobs (``video_backbone/cache.py``).
    cache_module_hash: Optional[str] = None
    max_memory_cache_size: float = 20e9
    cache_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.cache_enabled and self.train_backbone:
            raise ValueError("cache_enabled and train_backbone cannot both be True.")


@dataclass
class TimmBackboneConfig(VideoBackboneConfig):
    pad_to_square: bool = True
    model_type: Optional[str] = None
    # Encoder compute dtype; parameters stay float32.
    compute_dtype: str = "bfloat16"
    # "exact" (erf) or "tanh". SwinV2: tanh blocks run the fused block
    # kernel (K1), exact blocks window attention (K2) with plain Linear and
    # LayerNorm. ViT: the gelu of the blocks' MLP.
    gelu: str = "exact"
    # Recompute each encoder block in the backward (backbone training).
    remat: bool = False


@dataclass
class InverseFormBackboneConfig(VideoBackboneConfig):
    # The reference downloads the checkpoint; this build reads files only.
    download_model: bool = False
    model_path: Optional[str] = None

    def __post_init__(self):
        super().__post_init__()
        if self.download_model:
            raise ValueError("download_model: this build has no network; give model_path")
