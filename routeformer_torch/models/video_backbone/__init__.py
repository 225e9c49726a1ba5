from routeformer_torch.models.video_backbone.config import TimmBackboneConfig
from routeformer_torch.models.video_backbone.swin import SwinV2Backbone

__all__ = ["SwinV2Backbone", "TimmBackboneConfig"]
