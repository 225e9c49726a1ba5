"""Adapted GIMO baseline (counterpart of ``routeformer_tpu/baselines/gimo.py``):
motion, gaze and scene encoders with bidirectional cross-attention fusion,
adapted to this data (the Perceive frame encoder supplies the scene
features; 2-D gaze). GIMO's block conventions: the attention residual
inside the attention (``q + dropout(attn)``), pre-norm on q and kv, a
residual exact-gelu FFN, latent arrays as parameters. The frame encoder is
the port's ``PerceiveEncoder`` in f32, so under
``ROUTEFORMER_FUSION_KERNEL=1`` it runs K3a (and K3b in its backward); its
three views are three backbone calls."""

from typing import Optional, Type

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from routeformer_torch.baselines.video import encode_single_video
from routeformer_torch.models.cross_modal import PerceiveEncoder
from routeformer_torch.models.layers.encdec import LN_EPS
from routeformer_torch.models.video_backbone.swin import SwinV2Backbone
from routeformer_torch.ops.attention import dot_product_attention
from routeformer_torch.utils.filter import median_downsampler

BetterPerceiveEncoder = PerceiveEncoder  # the JAX module's name for the frame encoder


def _latent(*shape) -> nn.Parameter:
    return nn.Parameter(torch.clamp(0.02 * torch.randn(*shape), -2.0, 2.0))


class MultiHeadAttention(nn.Module):
    """Residual attention with its own kv width."""

    def __init__(self, num_heads, num_q_channels, num_kv_channels, dropout=0.1):
        super().__init__()
        self.n_heads = num_heads
        d = num_q_channels
        self.wq = nn.Linear(d, d)
        self.wk = nn.Linear(num_kv_channels, d)
        self.wv = nn.Linear(num_kv_channels, d)
        self.wo = nn.Linear(d, d)
        self.dropout = nn.Dropout(dropout)

    def forward(self, q, kv):
        b, l, d = q.shape
        s, h = kv.shape[1], self.n_heads
        out = dot_product_attention(self.wq(q).reshape(b, l, h, d // h),
                                    self.wk(kv).reshape(b, s, h, d // h),
                                    self.wv(kv).reshape(b, s, h, d // h))
        return q + self.dropout(self.wo(out.reshape(b, l, d)))


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in, d_hid, dropout=0.1):
        super().__init__()
        self.w1 = nn.Linear(d_in, d_hid)
        self.w2 = nn.Linear(d_hid, d_in)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        return x + self.dropout(self.w2(F.gelu(self.w1(x))))


class SelfAttentionLayer(nn.Module):
    def __init__(self, num_heads, num_q_channels, dropout=0.1):
        super().__init__()
        self.norm = nn.LayerNorm(num_q_channels, eps=LN_EPS)
        self.attn = MultiHeadAttention(num_heads, num_q_channels, num_q_channels, dropout)
        self.mlp = PositionwiseFeedForward(num_q_channels, num_q_channels, dropout)

    def forward(self, x):
        y = self.norm(x)
        return self.mlp(self.attn(y, y))


class CrossAttentionLayer(nn.Module):
    def __init__(self, num_heads, num_q_channels, num_kv_channels, dropout=0.1):
        super().__init__()
        self.q_norm = nn.LayerNorm(num_q_channels, eps=LN_EPS)
        self.kv_norm = nn.LayerNorm(num_kv_channels, eps=LN_EPS)
        self.attn = MultiHeadAttention(num_heads, num_q_channels, num_kv_channels, dropout)
        self.mlp = PositionwiseFeedForward(num_q_channels, num_q_channels, dropout)

    def forward(self, q, kv):
        return self.mlp(self.attn(self.q_norm(q), self.kv_norm(kv)))


def _sinusoid_table(n_position, d_hid) -> torch.Tensor:
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.from_numpy(table.astype(np.float32))


class GIMOPerceiveEncoder(nn.Module):
    """Latent-array Perceiver encoder: one cross-attention from the latents
    to the (position-encoded) inputs, then self-attention layers."""

    def __init__(self, n_input_channels, n_latent, n_latent_channels=512,
                 n_cross_att_heads=1, n_self_att_heads=8, n_self_att_layers=6,
                 dropout=0.1, n_position=400):
        super().__init__()
        self.register_buffer("pos_table", _sinusoid_table(n_position, n_input_channels),
                             persistent=False)
        self.dropout = nn.Dropout(dropout)
        self.cross_att = CrossAttentionLayer(n_cross_att_heads, n_latent_channels,
                                             n_input_channels, dropout)
        self.self_att = nn.ModuleList(
            [SelfAttentionLayer(n_self_att_heads, n_latent_channels, dropout)
             for _ in range(n_self_att_layers)])
        self.latent = _latent(n_latent, n_latent_channels)

    def forward(self, feats):
        b, l, _ = feats.shape
        enc = self.dropout(feats + self.pos_table[None, :l])
        x = self.cross_att(self.latent[None].expand(b, -1, -1), enc)
        for layer in self.self_att:
            x = layer(x)
        return x


class GIMOPerceiveDecoder(nn.Module):
    """Learnable-query cross-attention decoder."""

    def __init__(self, n_query, n_query_channels, n_latent_channels,
                 n_cross_att_heads=1, dropout=0.1):
        super().__init__()
        self.cross_att = CrossAttentionLayer(n_cross_att_heads, n_query_channels,
                                             n_latent_channels, dropout)
        self.query_latent = _latent(n_query, n_query_channels)

    def forward(self, query, latent):
        return self.cross_att(query + self.query_latent[None], latent)


class AdaptedGIMO(nn.Module):
    """GIMO on Routeformer batches: future GPS ``(B, pred_len, 2)``."""

    def __init__(self, configs, video_backbone: Optional[Type] = SwinV2Backbone):
        super().__init__()
        self.configs = configs
        h = configs.encoder_hidden_size
        input_len = configs.gps_backbone_config.seq_len
        output_len = configs.gps_backbone_config.pred_len
        drop = configs.feature_dropout
        self.video_backbone = video_backbone(configs.video_backbone_config)
        self.frame_encoder = PerceiveEncoder(
            self.video_backbone.output_feature_shape[-1], configs.image_embedding_size, 1,
            n_heads=configs.encoder_heads, layers=configs.encoder_layers, dropout=drop,
            d_ff=configs.encoder_d_ff)

        def encoder(n_in):
            return GIMOPerceiveEncoder(n_in, output_len, h,
                                       n_self_att_heads=configs.encoder_heads,
                                       n_self_att_layers=configs.encoder_layers, dropout=drop)

        self.motion_linear = nn.Linear(2, h)
        self.motion_encoder = encoder(2 * h)
        self.motion_decoder = GIMOPerceiveDecoder(output_len, h, h, dropout=drop)
        self.motion_scene_decoder = GIMOPerceiveDecoder(input_len, h, 2 * h, dropout=drop)
        self.gaze_scene_decoder = GIMOPerceiveDecoder(input_len, h, h, dropout=drop)
        self.gaze_linear = nn.Linear(2, h)
        self.gaze_encoder = encoder(h)
        self.gaze_motion_decoder = GIMOPerceiveDecoder(output_len, h, h, dropout=drop)
        self.motion_gaze_decoder = GIMOPerceiveDecoder(output_len, h, h, dropout=drop)
        self.embedding_layer = PositionwiseFeedForward(4 * h, 4 * h)
        self.output_encoder = encoder(4 * h)
        self.outputlayer = nn.Linear(h, 2)

    def _forward_single_video(self, video):
        return encode_single_video(self.video_backbone, self.frame_encoder, video,
                                   self.configs.image_embedding_size)

    def forward(self, batch: dict):
        cfg = self.configs
        gps = batch["gps"].float()
        motions = F.pad(gps[:, 1:] - gps[:, :-1], (0, 0, 1, 0))
        left = batch["left_video"]
        right = batch.get("right_video", left)
        scene_feats = torch.cat([self._forward_single_video(left),
                                 self._forward_single_video(right)], dim=2)
        scene_global = scene_feats[:, -1:].expand(-1, cfg.gps_backbone_config.pred_len, -1)

        motion_feats = self.motion_linear(motions)
        motion_scene = self.motion_scene_decoder(motion_feats, scene_feats)
        motion_embedding = self.motion_encoder(torch.cat([motion_feats, motion_scene], dim=2))

        gazes = median_downsampler(batch["gaze"].float(), cfg.gps_backbone_config.seq_len)
        front_feats = self._forward_single_video(batch["front_video"])
        gaze_embedding = self.gaze_scene_decoder(self.gaze_linear(gazes), front_feats)
        gaze_embedding = self.gaze_encoder(gaze_embedding)

        gaze_motion = self.gaze_motion_decoder(gaze_embedding, motion_embedding)
        motion_gaze = self.motion_gaze_decoder(motion_embedding, gaze_embedding)
        cross = self.embedding_layer(torch.cat([scene_global, gaze_motion, motion_gaze], dim=2))
        output = self.outputlayer(self.output_encoder(cross))
        return gps[:, -1:] + torch.cumsum(output, dim=1)
