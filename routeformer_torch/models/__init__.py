"""Models of the port: Routeformer, its Perceive encoder and decoder, and
its backbones."""

from routeformer_torch.models.config import RouteformerConfig
from routeformer_torch.models.cross_modal import PerceiveDecoder, PerceiveEncoder
from routeformer_torch.models.routeformer import Routeformer

__all__ = ["PerceiveDecoder", "PerceiveEncoder", "Routeformer", "RouteformerConfig"]
