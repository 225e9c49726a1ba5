"""FEDformer GPS backbone (counterpart of
``routeformer_tpu/models/gps_backbone/fedformer.py``): the frequency-enhanced
decomposition transformer. ``version="Wavelets"`` (the default) uses
Legendre multiwavelet blocks, ``version="Fourier"`` selected-mode Fourier
blocks (their modes drawn from ``mode_rng``, see ``layers/fourier.py``).
The forward is Autoformer's (``DecompositionForecaster``), the trend seed
projected to ``c_out`` as there.

As in the reference, ONE frequency block serves every encoder layer (and
one each every decoder layer): the layers share the module object, so its
parameters are tied. ``named_parameters`` and ``load_flax_params`` list a
shared parameter once, under its first layer's path, as flax does.
"""

from typing import Optional

import numpy as np
import torch.nn as nn

from routeformer_torch.models.gps_backbone.autoformer import DecompositionForecaster
from routeformer_torch.models.gps_backbone.config import FEDFormerBackboneConfig
from routeformer_torch.models.layers.autoformer_layers import (
    AutoCorrelationLayer,
    AutoformerDecoder,
    AutoformerDecoderLayer,
    AutoformerEncoder,
    AutoformerEncoderLayer,
    SeasonalLayerNorm,
    SeriesDecomp,  # noqa: F401  (re-exported as in the JAX module)
    SeriesDecompMulti,  # noqa: F401
    make_decomp,
)
from routeformer_torch.models.layers.embed import DataEmbedding_wo_pos  # noqa: F401
from routeformer_torch.models.layers.fourier import FourierBlock, FourierCrossAttention
from routeformer_torch.models.layers.multiwavelet import MultiWaveletCross, MultiWaveletTransform


class FEDformer(DecompositionForecaster):
    """Frequency-enhanced decomposition transformer, O(N)."""

    def __init__(self, configs: FEDFormerBackboneConfig,
                 mode_rng: Optional[np.random.RandomState] = None):
        super().__init__()
        c = configs
        self.version = c.get("version", "Wavelets")
        self.mode_select = c.get("mode_select", "random")
        self.modes = c.get("modes", 32)
        self._common(c)
        self.decomp = make_decomp(c.moving_avg)
        base = c.get("base", "legendre")
        seq_len_q = c.seq_len // 2 + c.pred_len
        if self.version == "Wavelets":
            encoder_self_att = MultiWaveletTransform(ich=c.d_model, L=c.get("L", 0), base=base)
            decoder_self_att = MultiWaveletTransform(ich=c.d_model, L=c.get("L", 0), base=base)
            decoder_cross_att = MultiWaveletCross(
                in_channels=c.d_model, out_channels=c.d_model, seq_len_q=seq_len_q,
                seq_len_kv=c.seq_len, modes=self.modes, ich=c.d_model, base=base,
                activation=c.get("cross_activation", "tanh"))
        else:
            rng = mode_rng if mode_rng is not None else np.random.RandomState(0)
            fourier = dict(in_channels=c.d_model, out_channels=c.d_model, modes=self.modes,
                           mode_select_method=self.mode_select, n_heads=c.n_heads, rng=rng)
            encoder_self_att = FourierBlock(seq_len=c.seq_len, **fourier)
            decoder_self_att = FourierBlock(seq_len=seq_len_q, **fourier)
            decoder_cross_att = FourierCrossAttention(seq_len_q=seq_len_q,
                                                      seq_len_kv=c.seq_len, **fourier)

        layer = dict(moving_avg=c.moving_avg, dropout=c.dropout, activation=c.activation)
        self.encoder = AutoformerEncoder(
            [AutoformerEncoderLayer(
                AutoCorrelationLayer(c.d_model, c.n_heads, inner=encoder_self_att),
                c.d_model, c.d_ff, **layer) for _ in range(c.e_layers)],
            norm_layer=SeasonalLayerNorm(c.d_model),
        )
        self.decoder = AutoformerDecoder(
            [AutoformerDecoderLayer(
                AutoCorrelationLayer(c.d_model, c.n_heads, inner=decoder_self_att),
                AutoCorrelationLayer(c.d_model, c.n_heads, inner=decoder_cross_att),
                c.d_model, c.c_out, c.d_ff, **layer) for _ in range(c.d_layers)],
            norm_layer=SeasonalLayerNorm(c.d_model),
            projection=nn.Linear(c.d_model, c.c_out),
        )
