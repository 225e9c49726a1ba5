"""InverseForm video backbone (counterpart of
``routeformer_tpu/models/video_backbone/inverseform.py``): the HRNet-16
trunk (``hrnet.py``) as a feature extractor, its 240-channel map pooled to
8x8.

- Frames are fed raw: uint8 -> f16 [0, 1] -> f32, no normalisation, as
  the reference feeds them. The backbone has no canonical input size, so
  the Routeformer runs it once per pixel stream (it has no
  ``preprocess_frames``/``encode_frames`` split).
- The pool: an exact mean over ``(H/8, W/8)`` cells when the map divides,
  else a bilinear resize to 8x8, which antialiases as it shrinks
  (``jax.image.resize``; ``ops/image.resize_video``).
- Training (``train_backbone`` or ``unfreeze``) keeps autograd through
  stage 4 only: the branches are detached before it, the reference's
  static partial freeze. InverseForm takes no part in the trainer's
  epoch-10 unfreeze (``epoch_unfreeze`` False).
- ``model_path`` (when the file exists) loads a torch checkpoint through
  ``convert.load_hrnet_torch``.
"""

from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn as nn

from routeformer_torch.models.video_backbone.config import (
    InverseFormBackboneConfig,
    VideoBackboneModule,
)
from routeformer_torch.models.video_backbone.hrnet import HighResolutionNet16
from routeformer_torch.ops.image import resize_video, to_float16
from routeformer_torch.utils.logging import get_logger

logger = get_logger("video_backbone.inverseform")


class InverseForm(VideoBackboneModule):
    """HRNet-16 trunk and an adaptive 8x8 pool."""

    POOL_HW = (8, 8)
    epoch_unfreeze = False

    def __init__(self, configs: Optional[InverseFormBackboneConfig] = None):
        super().__init__()
        configs = configs or InverseFormBackboneConfig()
        self.configs = configs
        self.unfreeze = False
        self.backbone = HighResolutionNet16()
        self.output_feature_shape: Tuple[int, int, int] = (*self.POOL_HW,
                                                            self.backbone.high_level_ch)
        model_path = configs.get("model_path")
        if model_path and Path(model_path).exists():
            from routeformer_torch.models.video_backbone.convert import load_hrnet_torch

            state = torch.load(model_path, map_location="cpu", weights_only=True)
            if isinstance(state, dict) and "state_dict" in state:
                state = state["state_dict"]
            n_loaded, n_total = load_hrnet_torch(self.backbone, state)
            logger.info("InverseForm checkpoint %s: %d/%d params loaded", model_path,
                        n_loaded, n_total)

    @property
    def trainable(self) -> bool:
        return bool(self.configs.train_backbone or self.unfreeze)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) frames in [0, 1] (or uint8) -> (N, 8, 8, 240)."""
        if images.dtype == torch.uint8:
            images = to_float16(images)
        feats = self.backbone(images.float(), stop_before_stage4=self.trainable)
        ph, pw = self.POOL_HW
        n, fh, fw, c = feats.shape
        if fh % ph == 0 and fw % pw == 0:
            out = feats.reshape(n, ph, fh // ph, pw, fw // pw, c).mean(dim=(2, 4))
        else:
            out = resize_video(feats, self.POOL_HW)
        return out if self.trainable else out.detach()
