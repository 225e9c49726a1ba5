from routeformer_torch.models.gps_backbone.baselines import LinearBaseline, StationaryBaseline
from routeformer_torch.models.gps_backbone.config import GPSBackboneConfig
from routeformer_torch.models.gps_backbone.informer import Informer

__all__ = ["GPSBackboneConfig", "Informer", "LinearBaseline", "StationaryBaseline"]
