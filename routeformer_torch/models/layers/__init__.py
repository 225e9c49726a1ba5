"""Layer library on the Informer and Perceive path."""

from routeformer_torch.models.layers.attention import (
    AttentionLayer,
    FullAttention,
    Linear,
    ProbAttention,
)
from routeformer_torch.models.layers.embed import (
    DataEmbedding,
    DataEmbedding_onlypos,
    DataEmbedding_wo_pos,
    FixedEmbedding,
    PositionalEmbedding,
    TemporalEmbedding,
    TimeFeatureEmbedding,
    TokenEmbedding,
)
from routeformer_torch.models.layers.encdec import (
    ConvLayer,
    Decoder,
    DecoderLayer,
    Encoder,
    EncoderLayer,
)

__all__ = [
    "AttentionLayer", "ConvLayer", "DataEmbedding", "DataEmbedding_onlypos",
    "DataEmbedding_wo_pos", "Decoder", "DecoderLayer", "Encoder", "EncoderLayer",
    "FixedEmbedding", "FullAttention", "Linear", "PositionalEmbedding", "ProbAttention",
    "TemporalEmbedding", "TimeFeatureEmbedding", "TokenEmbedding",
]
