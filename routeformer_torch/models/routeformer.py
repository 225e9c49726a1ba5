"""Routeformer, eval and train forward (counterpart of
``routeformer_tpu/models/routeformer.py``).

Motion features from GPS velocities, scene video (left/right views) and the
front camera through one merged backbone pass (the class given as
``video_backbone``: SwinV2 by default, or a ViT such as ``DinoV2``) and
the frame encoder, whose width is the backbone's feature width, the gaze
path (median downsampling, gaze encoder, gaze-video decoder), view
embeddings and output-query tokens into the video encoder, then the
Informer and cumsum integration onto the last GPS fix, with the dense
visual-feature split. Video is channel-last ``(B, T, H, W, C)``.

In training (``model.train()``): motion noise on the GPS, view dropout
(one decision per batch and a coin for which view), gaze dropout (one
decision per batch), and the feature dropout and fresh ProbSparse key
samples of the layers. The decisions are drawn from the CPU's default
generator, the noise and masks from the device's. On a mesh with several
data shards the trainer sets ``shared_generator`` (the same stream on every
rank): the per-batch decisions come from it, so every rank runs the same
modules, while the per-row noise and masks stay on each rank's own stream. The video backbone is
frozen, as the JAX package's ``stop_gradient`` makes it: it runs without
autograd unless its ``unfreeze`` attribute (or its config's
``train_backbone``) is set. A backbone without a canonical input size
(InverseForm) runs once per pixel stream.
A batch may carry the frozen backbone's feature maps instead of pixels
(``left_video_features`` etc., full timeline, zeros where no frame is
sampled; ``models/video_backbone/cache.py`` makes them): those streams skip
the backbone.

With ``autoregressive`` the eval forward decodes in chunks of
``autoregressive_step_size`` (the JAX package's two ``lax.scan``s, here one
Python loop): the GPS backbone's ``pred_len`` is rebound to the step (and
restored), each chunk's motion and dense features are rolled into the
inputs of the next, and the chunks are concatenated and cut to
``pred_len``. Training runs the plain forward over the whole horizon.
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from routeformer_torch.models.config import RouteformerConfig
from routeformer_torch.models.cross_modal import PerceiveDecoder, PerceiveEncoder
from routeformer_torch.models.gps_backbone import Informer
from routeformer_torch.models.video_backbone.swin import SwinV2Backbone
from routeformer_torch.utils import profiling
from routeformer_torch.utils.filter import median_downsampler
from routeformer_torch.utils.vector import estimate_angle_and_norm, rotate


def fps_subsample_indices(length: int, relative_fps: int) -> np.ndarray:
    """Every ``relative_fps``-th frame counting back from the last."""
    # A copy, not ascontiguousarray: a one-element reversed view counts as
    # contiguous and keeps its negative stride, which torch cannot take.
    return np.arange(length - 1, 0, -relative_fps)[::-1].copy()


def fps_subsample_slice(length: int, relative_fps: int) -> slice:
    """``fps_subsample_indices`` as a slice, which indexes a device tensor
    with no index copied to the device (a copy would wait for the stream)."""
    return slice((length - 1) % relative_fps or relative_fps, None, relative_fps)


class Routeformer(nn.Module):
    def __init__(self, configs: RouteformerConfig, gps_backbone: type = Informer,
                 video_backbone: type = SwinV2Backbone):
        super().__init__()
        self.shared_generator: Optional[torch.Generator] = None
        self.data_group = None  # the data shards' group on a mesh with several
        self.configs = cfg = configs.copy()
        self.with_video = cfg.with_video
        self.with_scene = cfg.with_scene
        self.with_gaze = cfg.with_gaze
        if self.with_gaze and not self.with_video:
            raise ValueError("Current gaze backbone requires a video backbone.")
        if self.with_video and not (self.with_scene or self.with_gaze):
            raise ValueError("with_video requires with_scene and/or with_gaze")
        seq_len = cfg.gps_backbone_config.seq_len
        if self.with_video:
            self.video_backbone = video_backbone(cfg.video_backbone_config)
            feat_c = self.video_backbone.output_feature_shape[-1]
            enc = dict(n_heads=cfg.encoder_heads, layers=cfg.encoder_layers,
                       d_ff=cfg.encoder_d_ff, dropout=cfg.feature_dropout,
                       compute_dtype=cfg.compute_dtype)
            emb = cfg.image_embedding_size
            self.frame_encoder = PerceiveEncoder(feat_c, emb, 1, **enc)
            for name in ("left_video_embedding", "right_video_embedding",
                         "gaze_video_embedding", "video_output_embedding"):
                setattr(self, name, nn.Parameter(torch.randn(1, 1, emb)))
            self.video_encoder = PerceiveEncoder(emb, cfg.encoder_hidden_size,
                                                 seq_len, **enc)
            if self.with_gaze:
                self.gaze_encoder = PerceiveEncoder(2, cfg.encoder_hidden_size,
                                                    seq_len, **enc)
                self.gaze_video_decoder = PerceiveDecoder(
                    cfg.encoder_hidden_size, cfg.encoder_hidden_size,
                    cfg.encoder_hidden_size, seq_len,
                    dropout=cfg.feature_dropout, d_ff=cfg.encoder_d_ff,
                    n_heads=cfg.cross_modal_decoder_heads,
                    layers=cfg.cross_modal_decoder_layers, mix=False,
                    compute_dtype=cfg.compute_dtype,
                )
        self.gps_backbone = gps_backbone(cfg.gps_backbone_config)

    # ------------------------------------------------------------------ #

    def forward(self, batch: dict):
        """``batch``: ``gps (B, T, 2)``, ``left_video``/``right_video``/
        ``front_video (B, T, H, W, C)``, ``gaze (B, Tg, 2)`` tensors.

        Returns future GPS ``(B, pred_len, 2)``, or ``(gps, dense)`` with
        ``dense_prediction``.
        """
        motion_dynamics, visual_features = self.preprocess_batch(batch)
        last_input_gps = batch["gps"][:, -1:, :]
        if self.configs.autoregressive and not self.training:
            gps, dense = self._autoregressive_decode(motion_dynamics, visual_features,
                                                     last_input_gps)
        else:
            output, _ = self._forward(motion_dynamics, visual_features)
            gps, dense = self.postprocess_batch(last_input_gps, output)
        if self.configs.dense_prediction:
            return gps, dense
        return gps

    def _autoregressive_decode(self, motion_dynamics, visual_features, last_input_gps):
        """``(future_gps, future_dense)`` decoded ``autoregressive_step_size``
        steps at a time."""
        cfg = self.configs
        step = cfg.autoregressive_step_size
        backbone = self.gps_backbone
        pred_len = backbone.pred_len
        if self.with_video:
            assert cfg.dense_prediction, (
                "Autoregressive decoding with video requires dense_prediction "
                "(the visual feature stream must be re-fed each step).")
        backbone.pred_len = step
        try:
            md, vf, last_gps = motion_dynamics, visual_features, last_input_gps
            gps_steps, dense_steps = [], []
            for _ in range(-(-pred_len // step)):
                output, _ = self._forward(md, vf)
                motion = self._future_motion(output)
                gps, dense = self.postprocess_batch(last_gps, output)
                # the carry keeps its dtype, as the scan's carry must
                md = torch.cat([md[:, step:], motion.to(md.dtype)], dim=1)
                if self.with_video:
                    vf = torch.cat([vf[:, step:], dense.to(vf.dtype)], dim=1)
                    dense_steps.append(dense)
                last_gps = gps[:, -1:]
                gps_steps.append(gps)
        finally:
            backbone.pred_len = pred_len
        future_dense = torch.cat(dense_steps, dim=1)[:, :pred_len] if dense_steps else None
        return torch.cat(gps_steps, dim=1)[:, :pred_len], future_dense

    def _forward(self, motion_dynamics, visual_features):
        """``(output, attention)``: the GPS backbone's output and, with
        ``configs.output_attention``, its encoder's attention maps (one per
        layer; None where the layer's attention is ProbSparse), else None."""
        angle, norm = estimate_angle_and_norm(motion_dynamics)
        if self.configs.rotate_motion:
            origin_angles = angle[:, -1:, :]
        else:
            origin_angles = angle[:, :1, :]
        normalized_angles = (angle - origin_angles) / math.pi
        acceleration = nn.functional.pad(norm[:, 1:] - norm[:, :-1], (0, 0, 1, 0))
        if self.configs.rotate_motion:
            motion_dynamics = rotate(motion_dynamics, -origin_angles)
        inputs = [torch.cat([motion_dynamics, normalized_angles, norm,
                             acceleration], dim=-1)]
        if self.with_video:
            inputs.append(visual_features)
        if self.configs._only_motion:
            inputs[-1] = torch.zeros_like(inputs[-1])
        x = torch.cat(inputs, dim=-1)
        attention = None
        with profiling.span("rf.gps_backbone"):
            if self.configs.output_attention:
                output, attention = self.gps_backbone(x)
            else:
                output = self.gps_backbone(x)
        if self.configs.decoder_mode == "recursive":
            width = None if self.configs.dense_prediction else 2
            output = output + x[:, -1:, :width]
        if self.configs.rotate_motion:
            output = torch.cat([rotate(output[..., :2], origin_angles),
                                output[..., 2:]], dim=-1)
        return output, attention

    def preprocess_batch(self, batch: dict, training=None):
        """``(motion_dynamics, visual_features)``; ``training`` (default: the
        module's mode) switches motion noise and view and gaze dropout."""
        cfg = self.configs
        if training is None:
            training = self.training
        gps = batch["gps"].float()
        if cfg.motion_noise > 0.0 and training:
            gps = gps + torch.randn_like(gps) * cfg.motion_noise
        motion = gps[:, 1:] - gps[:, :-1]
        if cfg.normalize_motion:
            motion = (motion - cfg.motion_mean) / cfg.motion_std
        motion_dynamics = nn.functional.pad(motion, (0, 0, 1, 0))
        if not self.with_video:
            return motion_dynamics, None

        # Left, right and front frames ride one backbone pass and one
        # frame-encoder call. Streams are (frames, precomputed).
        streams, meta = [], {}
        drop_left = drop_right = False
        if self.with_scene:
            pre = "left_video_features" in batch
            key = "_video_features" if pre else "_video"
            left = batch["left" + key]
            right = batch.get("right" + key, left)
            if training:
                drop_left, drop_right = self._view_drops("right" + key in batch)
            t = fps_subsample_slice(left.shape[1], cfg.output_fps // cfg.video_fps)
            meta["scene"] = (left.shape[0], left.shape[1], t)
            streams += [(left[:, t].flatten(0, 1), pre), (right[:, t].flatten(0, 1), pre)]
        if self.with_gaze:
            pre = "front_video_features" in batch
            front = batch["front_video_features" if pre else "front_video"]
            t = fps_subsample_slice(front.shape[1], cfg.output_fps // cfg.gaze_fps)
            meta["front"] = (front.shape[0], front.shape[1], t)
            streams.append((front[:, t].flatten(0, 1), pre))
        encoded = self._encode_frame_streams(streams)

        visual = []
        if self.with_scene:
            left_feats, right_feats = encoded[0], encoded[1]
            if drop_left:
                left_feats = torch.zeros_like(left_feats)
            if drop_right:
                right_feats = torch.zeros_like(right_feats)
            visual += [
                self._scatter_timeline(left_feats, *meta["scene"])
                + self.left_video_embedding,
                self._scatter_timeline(right_feats, *meta["scene"])
                + self.right_video_embedding,
            ]
        if self.with_gaze:
            gaze_video = self._scatter_timeline(encoded[-1], *meta["front"])
            in_len = gaze_video.shape[1]
            gaze = median_downsampler(batch["gaze"].float(),
                                      cfg.gps_backbone_config.seq_len)
            with profiling.span("rf.perceive.gaze"):
                gaze = self.gaze_encoder(gaze)
            with profiling.span("rf.perceive.gaze_video"):
                gaze_features = self.gaze_video_decoder(gaze_video, gaze)[:, :in_len]
            if cfg.gaze_dropout > 0.0 and training and self._draw() < cfg.gaze_dropout:
                gaze_features = torch.zeros_like(gaze_features)
            visual.append(gaze_features + self.gaze_video_embedding)
        visual.append(torch.zeros_like(visual[-1]) + self.video_output_embedding)
        with profiling.span("rf.perceive.video"):
            return motion_dynamics, self.video_encoder(torch.cat(visual, dim=1))

    def _view_drops(self, has_right: bool):
        """View dropout: with probability ``view_dropout`` one view is
        dropped, a fair coin says which; a missing right view is dropped."""
        drop_one = self.configs.view_dropout > 0.0 and bool(
            self._draw() < self.configs.view_dropout)
        drop_left = drop_one and bool(self._draw() < 0.5)
        drop_right = (drop_one and not drop_left) or not has_right
        return drop_left, drop_right

    def _draw(self) -> torch.Tensor:
        """One uniform for a per-batch decision."""
        g = self.shared_generator
        return torch.rand(()) if g is None else torch.rand((), generator=g, device=g.device)

    def _future_motion(self, output):
        cfg = self.configs
        motion = output[..., :2]
        if cfg.normalize_motion:
            motion = motion * cfg.motion_std + cfg.motion_mean
        return motion

    def postprocess_batch(self, last_input_gps, output):
        cfg = self.configs
        motion = self._future_motion(output)
        gps = (last_input_gps + torch.cumsum(motion, dim=1)).to(last_input_gps.dtype)
        dense = None
        if self.with_video and cfg.dense_prediction:
            dense = output[..., 2 : 2 + cfg.image_embedding_size]
        return gps, dense

    def _encode_frame_streams(self, streams):
        """``[(frames, precomputed)]`` -> per-stream ``(N_i, emb)``: the pixel
        streams through one backbone pass (or one per stream, for a backbone
        without the ``preprocess_frames``/``encode_frames`` split), the
        precomputed feature maps as f32, then one frame-encoder call over
        all of them. The backbone keeps autograd only when it trains
        (``train_backbone`` or ``unfreeze``)."""
        bb = self.video_backbone
        sizes = [s.shape[0] for s, _ in streams]
        maps = [s.float() if pre else None for s, pre in streams]
        pixel = [i for i, (_, pre) in enumerate(streams) if not pre]
        if pixel:
            trainable = bool(getattr(bb, "unfreeze", False)
                             or getattr(bb.configs, "train_backbone", False))
            with torch.set_grad_enabled(torch.is_grad_enabled() and trainable), \
                    profiling.span("rf.video_backbone"):
                if hasattr(bb, "encode_frames"):
                    feats = bb.encode_frames(torch.cat(
                        [bb.preprocess_frames(streams[i][0]) for i in pixel], dim=0))
                    parts = torch.split(feats, [sizes[i] for i in pixel])
                else:  # no canonical input size (InverseForm): once per stream
                    parts = [bb(streams[i][0]) for i in pixel]
            for i, part in zip(pixel, parts):
                maps[i] = part
        tokens = torch.cat([f.reshape(f.shape[0], -1, f.shape[-1]) for f in maps])
        tokens = torch.cat([tokens, -torch.ones_like(tokens[:, :1])], dim=1)
        with profiling.span("rf.perceive.frame"):
            encoded = self.frame_encoder(tokens).reshape(-1, self.configs.image_embedding_size)
        return torch.split(encoded, sizes, dim=0)

    @staticmethod
    def _scatter_timeline(feats, batch_size, length, frames: slice):
        """(B*T', emb) -> (B, T, emb), zeros where no frame was sampled."""
        feats = feats.reshape(batch_size, -1, feats.shape[-1])
        full = feats.new_zeros(batch_size, length, feats.shape[-1])
        full[:, frames] = feats
        return full
