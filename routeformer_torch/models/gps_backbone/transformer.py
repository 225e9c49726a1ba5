"""Vanilla Transformer GPS backbone (counterpart of
``routeformer_tpu/models/gps_backbone/transformer.py``): dense O(L²)
attention encoder and decoder (causal self-attention, cross-attention),
the decoder seeded with zeros for the ``pred_len`` future steps. Its
attention goes through ``ops/attention.dot_product_attention``, whose K4
route starts at 512 keys, above any length this backbone sees."""

import torch
import torch.nn as nn

from routeformer_torch.models.gps_backbone.config import GPSBackboneConfig
from routeformer_torch.models.layers import (
    AttentionLayer,
    DataEmbedding,
    Decoder,
    DecoderLayer,
    Encoder,
    EncoderLayer,
    FullAttention,
)
from routeformer_torch.models.layers.encdec import LN_EPS


class Transformer(nn.Module):
    def __init__(self, configs: GPSBackboneConfig):
        super().__init__()
        c = configs
        self.output_attention = c.output_attention
        self.pred_len = c.pred_len
        self.enc_embedding = DataEmbedding(c.enc_in, c.d_model, c.embed, c.freq, c.dropout)
        self.dec_embedding = DataEmbedding(c.dec_in, c.d_model, c.embed, c.freq, c.dropout)

        def attn(causal, output_attention=False):
            return AttentionLayer(FullAttention(causal, attention_dropout=c.dropout,
                                                output_attention=output_attention),
                                  c.d_model, c.n_heads)

        self.encoder = Encoder(
            [EncoderLayer(attn(False, c.output_attention), c.d_model, c.d_ff,
                          dropout=c.dropout, activation=c.activation) for _ in range(c.e_layers)],
            norm_layer=nn.LayerNorm(c.d_model, eps=LN_EPS),
        )
        self.decoder = Decoder(
            [DecoderLayer(attn(True), attn(False), c.d_model, c.d_ff, dropout=c.dropout,
                          activation=c.activation) for _ in range(c.d_layers)],
            norm_layer=nn.LayerNorm(c.d_model, eps=LN_EPS),
            projection=nn.Linear(c.d_model, c.c_out),
        )

    def forward(self, x: torch.Tensor):
        """``(B, seq_len, C) -> (B, pred_len, c_out)``; with
        ``output_attention``, ``(prediction, the encoder's attentions)``."""
        b, l, _ = x.shape
        marks = torch.arange(l + self.pred_len, dtype=torch.float32,
                             device=x.device)[None, :, None]
        x_dec = torch.cat([x, x.new_zeros(b, self.pred_len, x.shape[-1])], dim=1)
        enc_out = self.encoder(self.enc_embedding(x, marks[:, :l].expand(b, l, 1)))
        if self.output_attention:
            enc_out, attns = enc_out
        dec_out = self.decoder(self.dec_embedding(x_dec, marks.expand(b, -1, 1)), enc_out)
        if self.output_attention:
            return dec_out[:, -self.pred_len:], attns
        return dec_out[:, -self.pred_len:]
