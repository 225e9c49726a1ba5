"""Routeformer config (the port's copy of
``routeformer_tpu/models/config.py``): ``__post_init__`` validates the FPS
ratios and pushes derived fields into the GPS backbone config."""

from dataclasses import dataclass, field
from typing import Optional

from routeformer_torch.models.gps_backbone.config import GPSBackboneConfig
from routeformer_torch.models.video_backbone.config import VideoBackboneConfig
from routeformer_torch.utils.config import BaseConfig


@dataclass
class RouteformerConfig(BaseConfig):
    gps_backbone_config: GPSBackboneConfig
    video_backbone_config: Optional[VideoBackboneConfig] = None
    output_attention: bool = False
    with_video: Optional[bool] = None
    with_gaze: bool = False
    with_scene: bool = True
    discount_factor: dict = field(default_factory=lambda: {0: 0.9})
    decoder_mode: str = "vanilla"
    rotate_motion: bool = False
    loss_function: str = "smooth_l1"
    epsilon: Optional[float] = None
    visual_epsilon: Optional[float] = None
    autoregressive: bool = False
    autoregressive_step_size: int = 1
    dense_prediction: bool = False
    dense_loss_ratio: float = 0.25
    video_fps: int = 1
    gaze_fps: int = 1
    encoder_hidden_size: int = 64
    encoder_heads: int = 8
    encoder_layers: int = 2
    encoder_d_ff: int = 64
    cross_modal_decoder_heads: int = 8
    cross_modal_decoder_layers: int = 1
    normalize_motion: bool = False
    motion_mean: float = 0.0
    motion_std: float = 1.0
    motion_noise: float = 0.0
    view_dropout: float = 0.0
    gaze_dropout: float = 0.0
    feature_dropout: float = 0.0
    image_embedding_size: int = 128
    # Training-run settings the JAX driver records in the config.
    lr: float = 5e-4
    wd: float = 0
    optimizer: str = "Adam"
    batch_size: int = 32
    min_pci: float = 0.0
    step_size: int = 1
    epochs: int = 100
    output_fps: int = 5
    gopro_scaling_factor: float = 1.0
    front_scaling_factor: float = 1.0
    num_workers: int = 0
    use_cache: bool = False
    cache_dir: Optional[str] = None
    # "float32" or "bfloat16": Perceive Linear layers compute in this dtype.
    compute_dtype: str = "float32"
    _only_motion: bool = False

    def __post_init__(self):
        assert self.output_fps % self.video_fps == 0, (
            "Video FPS must be a divisor of the output FPS"
        )
        assert self.output_fps % self.gaze_fps == 0, (
            "Gaze FPS must be a divisor of the output FPS"
        )
        if self.with_video is None:
            self.with_video = self.video_backbone_config is not None
        if self.with_gaze:
            assert self.with_video, "Gaze backbone requires video backbone to be used"
        g = self.gps_backbone_config
        g.output_attention = self.output_attention
        g.with_video = self.with_video
        g.with_gaze = self.with_gaze
        g.dense_prediction = self.dense_prediction
        g.image_embedding_size = self.image_embedding_size
        g.encoder_hidden_size = self.encoder_hidden_size
        g.output_fps = self.output_fps
        g.dense_loss_ratio = self.dense_loss_ratio
        g.discount_factor = self.discount_factor
        g.smart_decoder = self.decoder_mode == "smart"
