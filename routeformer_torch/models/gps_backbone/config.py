"""GPS backbone configs (the port's copy of
``routeformer_tpu/models/gps_backbone/config.py``): the base config, and
PatchTST's, DLinear/NLinear's and FEDformer's."""

from dataclasses import dataclass, field
from typing import Optional

from routeformer_torch.utils.config import BaseConfig


@dataclass
class GPSBackboneConfig(BaseConfig):
    seq_len: int
    label_len: int
    pred_len: int
    embed: str = "timeF"
    freq: str = "m"
    d_model: int = 128
    n_heads: int = 8
    e_layers: int = 2
    d_layers: int = 1
    d_ff: int = 512
    moving_avg: int = 25
    factor: int = 1
    distil: bool = True
    dropout: float = 0.1
    activation: str = "gelu"
    individual: bool = False
    # Pushed down by RouteformerConfig.__post_init__.
    output_attention: bool = field(init=False, default=False)
    with_video: bool = field(init=False, default=False)
    with_gaze: bool = field(init=False, default=False)
    dense_prediction: bool = field(init=False, default=False)
    encoder_hidden_size: int = field(init=False, default=64)
    image_embedding_size: int = field(init=False, default=128)
    output_fps: int = field(init=False, default=5)
    dense_loss_ratio: float = field(init=False, default=0.25)
    discount_factor: dict = field(init=False, default_factory=lambda: {0: 0.9})
    smart_decoder: bool = field(init=False, default=False)
    _enc_in: Optional[int] = None
    _c_out: Optional[int] = None

    @property
    def c_out(self) -> int:
        if self._c_out is not None:
            return self._c_out
        if not self.dense_prediction:
            return 2
        return self.enc_in - 3  # drop angle, norm (speed), acceleration

    @property
    def enc_in(self) -> int:
        if self._enc_in is not None:
            return self._enc_in
        out = 2 + 3  # coords + angle, norm (speed), acceleration
        if not self.with_video:
            return out
        return out + self.encoder_hidden_size

    @property
    def dec_in(self) -> int:
        return self.enc_in


@dataclass
class PatchTSTBackboneConfig(GPSBackboneConfig):
    fc_dropout: float = 0.1
    head_dropout: float = 0.0
    patch_len_ratio: float = 0.25
    stride_ratio: float = 0.125
    padding_patch: str = "end"
    revin: bool = True
    affine: bool = False
    subtract_last: bool = False
    decomposition: bool = False
    kernel_size: int = 25

    @property
    def patch_len(self) -> int:
        return int(self.patch_len_ratio * self.seq_len)

    @property
    def stride(self) -> int:
        return int(self.stride_ratio * self.seq_len)


@dataclass
class LinearBackboneConfig(GPSBackboneConfig):
    kernel_size: int = 25


@dataclass
class FEDFormerBackboneConfig(GPSBackboneConfig):
    """FEDformer's config: ``version`` ``Wavelets`` (multiwavelet blocks) or
    ``Fourier`` (selected-mode Fourier blocks)."""

    version: str = "Wavelets"
    mode_select: str = "random"
    modes: int = 32
    L: int = 0
    base: str = "legendre"
    cross_activation: str = "tanh"
