from routeformer_torch.models.gps_backbone.baselines import LinearBaseline, StationaryBaseline
from routeformer_torch.models.gps_backbone.config import (
    GPSBackboneConfig,
    LinearBackboneConfig,
    PatchTSTBackboneConfig,
)
from routeformer_torch.models.gps_backbone.informer import Informer
from routeformer_torch.models.gps_backbone.linear import DLinear, NLinear
from routeformer_torch.models.gps_backbone.patchtst import PatchTST
from routeformer_torch.models.gps_backbone.transformer import Transformer

__all__ = ["DLinear", "GPSBackboneConfig", "Informer", "LinearBackboneConfig",
           "LinearBaseline", "NLinear", "PatchTST", "PatchTSTBackboneConfig",
           "StationaryBaseline", "Transformer"]
