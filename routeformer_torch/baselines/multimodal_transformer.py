"""MultiModalTransformer baseline (counterpart of
``routeformer_tpu/baselines/multimodal_transformer.py``): naive fusion, the
motion, left and right scene, gaze-video and gaze features concatenated
into one token stream for the vanilla Transformer backbone (``enc_in = 5 h``,
``c_out = 2``), the velocities integrated onto the last GPS fix. The frame
encoder is the port's f32 ``PerceiveEncoder``; each view is one backbone
call."""

from typing import Optional, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.baselines.video import encode_single_video
from routeformer_torch.models.cross_modal import PerceiveEncoder
from routeformer_torch.models.gps_backbone.transformer import Transformer
from routeformer_torch.models.video_backbone.swin import SwinV2Backbone
from routeformer_torch.utils.filter import median_downsampler


class MultiModalTransformer(nn.Module):
    def __init__(self, configs, video_backbone: Optional[Type] = SwinV2Backbone):
        super().__init__()
        self.configs = configs
        h = configs.encoder_hidden_size
        self.video_backbone = video_backbone(configs.video_backbone_config)
        self.frame_encoder = PerceiveEncoder(
            self.video_backbone.output_feature_shape[-1], configs.image_embedding_size, 1,
            n_heads=configs.encoder_heads, layers=configs.encoder_layers,
            dropout=configs.feature_dropout, d_ff=configs.encoder_d_ff)
        self.motion_linear = nn.Linear(2, h)
        self.gaze_linear = nn.Linear(2, h)
        gps_cfg = configs.gps_backbone_config.copy()
        gps_cfg._enc_in = h * 5
        gps_cfg._c_out = 2
        self.transformer = Transformer(gps_cfg)

    def _forward_single_video(self, video):
        return encode_single_video(self.video_backbone, self.frame_encoder, video,
                                   self.configs.image_embedding_size)

    def forward(self, batch: dict):
        gps = batch["gps"].float()
        motions = F.pad(gps[:, 1:] - gps[:, :-1], (0, 0, 1, 0))
        left = batch["left_video"]
        right = batch.get("right_video", left)
        gazes = median_downsampler(batch["gaze"].float(),
                                   self.configs.gps_backbone_config.seq_len)
        feats = torch.cat([
            self.motion_linear(motions),
            self._forward_single_video(left),
            self._forward_single_video(right),
            self._forward_single_video(batch["front_video"]),
            self.gaze_linear(gazes),
        ], dim=2)
        return gps[:, -1:] + torch.cumsum(self.transformer(feats), dim=1)
