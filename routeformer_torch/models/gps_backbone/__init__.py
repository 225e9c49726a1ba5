from routeformer_torch.models.gps_backbone.config import GPSBackboneConfig
from routeformer_torch.models.gps_backbone.informer import Informer

__all__ = ["GPSBackboneConfig", "Informer"]
