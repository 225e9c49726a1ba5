"""The frame path that AdaptedGIMO and MultiModalTransformer share: each
view is its own backbone call over every frame of the clip, then the
Perceive frame encoder over the feature tokens and one ``-1`` token."""

import torch
import torch.nn as nn


def encode_single_video(backbone: nn.Module, frame_encoder: nn.Module, video: torch.Tensor,
                        emb: int) -> torch.Tensor:
    """``(B, T, H, W, C) -> (B, T, emb)``. The backbone runs without
    autograd unless it is unfrozen or trained, as the JAX package's
    ``stop_gradient`` makes it."""
    b = video.shape[0]
    trainable = backbone.unfreeze or backbone.configs.train_backbone
    with torch.set_grad_enabled(torch.is_grad_enabled() and trainable):
        feats = backbone(video.flatten(0, 1))
    tokens = feats.reshape(feats.shape[0], -1, feats.shape[-1])
    tokens = torch.cat([tokens, -torch.ones_like(tokens[:, :1])], dim=1)
    return frame_encoder(tokens).reshape(b, -1, emb)
