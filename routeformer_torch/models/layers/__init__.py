"""Layer library on the Informer and Perceive path."""

from routeformer_torch.models.layers.attention import (
    AttentionLayer,
    FullAttention,
    Linear,
    ProbAttention,
)
from routeformer_torch.models.layers.embed import (
    DataEmbedding,
    PositionalEmbedding,
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
    "AttentionLayer", "ConvLayer", "DataEmbedding", "Decoder", "DecoderLayer",
    "Encoder", "EncoderLayer", "FullAttention", "Linear",
    "PositionalEmbedding", "ProbAttention", "TimeFeatureEmbedding",
    "TokenEmbedding",
]
