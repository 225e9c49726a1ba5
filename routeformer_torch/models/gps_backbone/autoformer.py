"""Autoformer GPS backbone (counterpart of
``routeformer_tpu/models/gps_backbone/autoformer.py``): series-wise
decomposition (moving-average trend plus seasonal residual) with
AutoCorrelation attention. The decoder is seeded with the label window's
seasonal part (zeros beyond it) and a trend stream from the input's mean,
projected to ``c_out`` and accumulated through each decoder layer.

``DecompositionForecaster`` holds the forward that Autoformer and FEDformer
share; each builds its own encoder and decoder.
"""

import torch
import torch.nn as nn

from routeformer_torch.models.gps_backbone.config import GPSBackboneConfig
from routeformer_torch.models.layers.autoformer_layers import (
    AutoCorrelationLayer,
    AutoformerDecoder,
    AutoformerDecoderLayer,
    AutoformerEncoder,
    AutoformerEncoderLayer,
    SeasonalLayerNorm,
    SeriesDecomp,
)
from routeformer_torch.models.layers.embed import DataEmbedding_wo_pos


class DecompositionForecaster(nn.Module):
    """The shared forward: ``decomp``, ``trend_projection``, the two
    embeddings, ``encoder`` and ``decoder`` are set by the subclass."""

    def _common(self, c: GPSBackboneConfig) -> None:
        self.seq_len, self.label_len, self.pred_len = c.seq_len, c.label_len, c.pred_len
        self.output_attention = c.output_attention
        self.trend_projection = nn.Linear(c.enc_in, c.c_out)
        self.enc_embedding = DataEmbedding_wo_pos(c.enc_in, c.d_model, c.embed, c.freq,
                                                  c.dropout)
        self.dec_embedding = DataEmbedding_wo_pos(c.dec_in, c.d_model, c.embed, c.freq,
                                                  c.dropout)

    def forward(self, x: torch.Tensor):
        """``(B, seq_len, C) -> (B, pred_len, c_out)``; with
        ``output_attention``, ``(prediction, the encoder's maps)``."""
        b, l, c = x.shape
        marks = torch.arange(l - self.label_len, l + self.pred_len, dtype=torch.float32,
                             device=x.device)[None, :, None]
        mark_enc = torch.arange(l, dtype=torch.float32, device=x.device)[None, :, None]
        mean = x.mean(dim=1, keepdim=True).expand(b, self.pred_len, c)
        seasonal_init, trend_init = self.decomp(x)
        trend_init = torch.cat([trend_init[:, -self.label_len:], mean], dim=1)
        seasonal_init = torch.cat([seasonal_init[:, -self.label_len:],
                                   x.new_zeros(b, self.pred_len, c)], dim=1)
        enc_out, attns = self.encoder(self.enc_embedding(x, mark_enc.expand(b, l, 1)))
        dec_out = self.dec_embedding(seasonal_init, marks.expand(b, -1, 1))
        seasonal_part, trend_part = self.decoder(dec_out, enc_out,
                                                 trend=self.trend_projection(trend_init))
        out = (trend_part + seasonal_part)[:, -self.pred_len:]
        return (out, attns) if self.output_attention else out


class Autoformer(DecompositionForecaster):
    """Series-wise transformer with O(L log L) autocorrelation attention."""

    def __init__(self, configs: GPSBackboneConfig):
        super().__init__()
        c = configs
        self._common(c)
        kernel = c.moving_avg
        self.decomp = SeriesDecomp(kernel[0] if isinstance(kernel, list) else kernel)

        def attn():
            return AutoCorrelationLayer(c.d_model, c.n_heads, factor=c.factor)

        layer = dict(moving_avg=c.moving_avg, dropout=c.dropout, activation=c.activation)
        self.encoder = AutoformerEncoder(
            [AutoformerEncoderLayer(attn(), c.d_model, c.d_ff, **layer)
             for _ in range(c.e_layers)],
            norm_layer=SeasonalLayerNorm(c.d_model),
        )
        self.decoder = AutoformerDecoder(
            [AutoformerDecoderLayer(attn(), attn(), c.d_model, c.c_out, c.d_ff, **layer)
             for _ in range(c.d_layers)],
            norm_layer=SeasonalLayerNorm(c.d_model),
            projection=nn.Linear(c.d_model, c.c_out),
        )
