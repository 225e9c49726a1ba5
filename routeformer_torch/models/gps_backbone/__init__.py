from routeformer_torch.models.gps_backbone.autoformer import Autoformer
from routeformer_torch.models.gps_backbone.baselines import LinearBaseline, StationaryBaseline
from routeformer_torch.models.gps_backbone.config import (
    FEDFormerBackboneConfig,
    GPSBackboneConfig,
    LinearBackboneConfig,
    PatchTSTBackboneConfig,
)
from routeformer_torch.models.gps_backbone.fedformer import FEDformer
from routeformer_torch.models.gps_backbone.informer import Informer
from routeformer_torch.models.gps_backbone.linear import DLinear, NLinear
from routeformer_torch.models.gps_backbone.patchtst import PatchTST
from routeformer_torch.models.gps_backbone.transformer import Transformer

# The backbone and config classes by name, as a serving bundle records them.
GPS_BACKBONES = {cls.__name__: cls for cls in (Autoformer, DLinear, FEDformer, Informer,
                                               LinearBaseline, NLinear, PatchTST,
                                               StationaryBaseline, Transformer)}
GPS_CONFIGS = {cls.__name__: cls for cls in (FEDFormerBackboneConfig, GPSBackboneConfig,
                                             LinearBackboneConfig, PatchTSTBackboneConfig)}

__all__ = ["Autoformer", "DLinear", "FEDFormerBackboneConfig", "FEDformer", "GPS_BACKBONES",
           "GPS_CONFIGS", "GPSBackboneConfig", "Informer", "LinearBackboneConfig", "LinearBaseline",
           "NLinear", "PatchTST", "PatchTSTBackboneConfig", "StationaryBaseline",
           "Transformer"]
