"""The flagship configuration and model (the port's copy of
``__graft_entry__.py::_flagship_config``): Informer d832/e6/d_ff 3328 with
factor 4, distil and the smart decoder; SwinV2-base (window 16 at 256 px,
tanh gelu, bf16 compute); d128 Perceive stacks of 8 and 2 layers with bf16
Linear layers; video and gaze, dense prediction, 5 Hz output.

``dinov2_config``/``build_dinov2`` are the same model with the DinoV2
ViT-B/14 at 518 px (exact gelu, bf16 compute) as its video backbone, the
JAX ``Routeformer(cfg, gps_backbone=Informer, video_backbone=DinoV2)``:
its ViT reaches K4 (1369 tokens per frame), and its frame encoder sees
1370 tokens.

``build_flagship_training`` adds the JAX package's flagship optimizer (AdamW
1e-5, weight decay 1e-4, backbone 1e-6, warmup 2 of 200 epochs, clip 2.5)
and returns a train step. ``ROUTEFORMER_FUSION_KERNEL`` chooses the Perceive
stacks' path (``models/cross_modal.py``).

Each build function takes ``gps`` and ``video`` to swap a backbone at the same
widths (``GPS_VARIANTS``, ``VIDEO_VARIANTS``): Autoformer and FEDformer
(Fourier, or multiwavelet with 32 modes) in the Informer's slot; the
driver's exact-gelu SwinV2, DinoV2 or InverseForm in the video slot. With
``train_backbone`` the video backbone trains with the model (the augment,
gradients through K1, K2 or K4); its config's ``remat``, read at each
forward, recomputes its blocks in the backward.
"""

import dataclasses
import math

import torch
import torch.nn as nn

from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import (
    Autoformer,
    FEDformer,
    FEDFormerBackboneConfig,
    GPSBackboneConfig,
    Informer,
)
from routeformer_torch.models.video_backbone import (
    DinoV2,
    InverseForm,
    InverseFormBackboneConfig,
    SwinV2Backbone,
    TimmBackboneConfig,
)
from routeformer_torch.optimizers import build_optimizer
from routeformer_torch.parallel import make_train_step
from routeformer_torch.train import TrainingLosses, routeformer_training_loss
from routeformer_torch.utils.device import DeviceLike, resolve_device


def flagship_config() -> RouteformerConfig:
    gps_cfg = GPSBackboneConfig(
        seq_len=40, label_len=40, pred_len=30,
        embed="timeF", freq="m", moving_avg=25, factor=4, distil=True,
        dropout=0.0, activation="relu", individual=False,
        d_model=832, n_heads=8, e_layers=6, d_layers=1, d_ff=832 * 4,
    )
    video_cfg = TimmBackboneConfig(
        model_type="swinv2_base_window12to16_192to256.ms_in22k_ft_in1k",
        cache_enabled=False, gelu="tanh",
    )
    return RouteformerConfig(
        gps_backbone_config=gps_cfg,
        video_backbone_config=video_cfg,
        with_video=True, with_gaze=True,
        dense_prediction=True, dense_loss_ratio=0.5,
        decoder_mode="smart",
        discount_factor={0: 0.97, 100: 0.98, 200: 0.99},
        epsilon=1.0, visual_epsilon=0.3,
        compute_dtype="bfloat16",
        image_embedding_size=64, encoder_hidden_size=64,
        encoder_heads=8, encoder_layers=8, encoder_d_ff=64 * 4,
        cross_modal_decoder_heads=8, cross_modal_decoder_layers=2,
        view_dropout=0.6, gaze_dropout=0.2, feature_dropout=0.05,
        output_fps=5, video_fps=1, gaze_fps=1,
    )


def dinov2_config() -> RouteformerConfig:
    """``flagship_config`` with the DinoV2 ViT-B/14 @518 backbone."""
    cfg = flagship_config()
    cfg.video_backbone_config = TimmBackboneConfig(
        model_type="vit_base_patch14_dinov2.lvd142m", gelu="exact",
        compute_dtype="bfloat16", cache_enabled=False,
    )
    return cfg


# name -> (GPS backbone class, its config class, fields over the flagship's)
GPS_VARIANTS = {
    "Informer": (Informer, GPSBackboneConfig, {}),
    "Autoformer": (Autoformer, GPSBackboneConfig, {}),
    "FEDformer-Fourier": (FEDformer, FEDFormerBackboneConfig, {"version": "Fourier"}),
    "FEDformer-Wavelets": (FEDformer, FEDFormerBackboneConfig,
                           {"version": "Wavelets", "modes": 32}),
}
# name -> video backbone class; its config is made by ``variant_config``
VIDEO_VARIANTS = {"SwinV2": SwinV2Backbone, "SwinV2-exact": SwinV2Backbone,
                  "DinoV2": DinoV2, "InverseForm": InverseForm}


def variant_config(gps: str = "Informer", video: str = "SwinV2",
                   train_backbone: bool = False) -> RouteformerConfig:
    """``flagship_config`` with the named backbones (``GPS_VARIANTS``,
    ``VIDEO_VARIANTS``) at the flagship's widths."""
    cfg = dinov2_config() if video == "DinoV2" else flagship_config()
    _, gps_cls, fields = GPS_VARIANTS[gps]
    g = cfg.gps_backbone_config
    base = {f.name: getattr(g, f.name) for f in dataclasses.fields(GPSBackboneConfig) if f.init}
    cfg.gps_backbone_config = gps_cls(**dict(base, **fields))
    if video == "InverseForm":
        cfg.video_backbone_config = InverseFormBackboneConfig(train_backbone=train_backbone)
    else:
        v = cfg.video_backbone_config
        v.train_backbone = train_backbone
        if video == "SwinV2-exact":
            v.gelu = "exact"
    return cfg.override()


def init_weights(model: nn.Module, seed: int) -> None:
    """Seeded initialisation, the same on every device: Linear/conv weights
    normal(0, 1/fan_in), biases 0, norms 1/0, the view embeddings
    normal(0, 1), the ViT's position embedding normal(0, 0.02) (its flax
    initialiser), SwinV2 logit scales log(10)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("_embedding") and p.ndim == 3 and p.shape[:2] == (1, 1):
                value = torch.randn(p.shape, generator=gen)
            elif leaf == "pos_embed":
                value = 0.02 * torch.randn(p.shape, generator=gen)
            elif leaf == "logit_scale":
                value = torch.full(p.shape, math.log(10.0))
            elif p.ndim >= 2:
                fan_in = p[0].numel()
                value = torch.randn(p.shape, generator=gen) / math.sqrt(fan_in)
            elif ".norm" in name or "_norm" in name or leaf == "weight":
                value = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
            else:
                value = torch.zeros(p.shape)
            p.copy_(value.to(p.device))


def build_flagship(seed: int = 0, device: DeviceLike = None, gps: str = "Informer",
                   video: str = "SwinV2", train_backbone: bool = False) -> Routeformer:
    """The flagship model (or a variant: ``variant_config``) with seeded
    weights, in eval mode, on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    model = Routeformer(variant_config(gps, video, train_backbone),
                        gps_backbone=GPS_VARIANTS[gps][0], video_backbone=VIDEO_VARIANTS[video])
    init_weights(model, seed)
    return model.to(dev).eval()


def build_dinov2(seed: int = 0, device: DeviceLike = None) -> Routeformer:
    """The DinoV2-backbone model with seeded weights, in eval mode, on
    ``device`` (CUDA by default)."""
    return build_flagship(seed, device, video="DinoV2")


def build_flagship_training(seed: int = 0, device: DeviceLike = None, gps: str = "Informer",
                            video: str = "SwinV2", train_backbone: bool = False):
    """``(model, optimizer, step)`` for the flagship (or a variant) on
    ``device`` (CUDA by default): ``step(input_batch, target_batch, epoch)
    -> metrics``. The video backbone's parameters form the optimizer's
    ``video_backbone`` group (rate 1e-6)."""
    model = build_flagship(seed, device, gps, video, train_backbone)
    optimizer = build_optimizer(
        model, learning_rate=1e-5, weight_decay=1e-4, video_backbone_lr=1e-6,
        warmup_epochs=2, max_epochs=200, gradient_clip_val=2.5,
    )
    losses = TrainingLosses.from_config(model.configs)

    def loss_fn(m, input_batch, target_batch, epoch):
        return routeformer_training_loss(m, input_batch, target_batch, epoch, losses)

    return model, optimizer, make_train_step(model, optimizer, loss_fn)
