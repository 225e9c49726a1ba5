"""Models of the port: Routeformer and its backbones."""

from routeformer_torch.models.config import RouteformerConfig
from routeformer_torch.models.routeformer import Routeformer

__all__ = ["Routeformer", "RouteformerConfig"]
