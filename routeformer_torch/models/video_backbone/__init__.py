from routeformer_torch.models.video_backbone.config import TimmBackboneConfig
from routeformer_torch.models.video_backbone.swin import SwinV2Backbone
from routeformer_torch.models.video_backbone.vit import DinoV2, Sam, TimmBackbone

# The backbone classes by name, as a serving bundle records them.
VIDEO_BACKBONES = {cls.__name__: cls for cls in (SwinV2Backbone, TimmBackbone, DinoV2, Sam)}

__all__ = ["DinoV2", "Sam", "SwinV2Backbone", "TimmBackbone", "TimmBackboneConfig",
           "VIDEO_BACKBONES"]
