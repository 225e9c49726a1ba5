from routeformer_torch.models.video_backbone.config import (
    InverseFormBackboneConfig,
    TimmBackboneConfig,
    VideoBackboneConfig,
    VideoBackboneModule,
)
from routeformer_torch.models.video_backbone.inverseform import InverseForm
from routeformer_torch.models.video_backbone.swin import SwinV2, SwinV2Backbone
from routeformer_torch.models.video_backbone.vit import DinoV2, Sam, TimmBackbone

# The backbone and config classes by name, as a serving bundle records them.
VIDEO_BACKBONES = {cls.__name__: cls for cls in (SwinV2Backbone, SwinV2, TimmBackbone, DinoV2,
                                                  Sam, InverseForm)}
VIDEO_CONFIGS = {cls.__name__: cls for cls in (TimmBackboneConfig, InverseFormBackboneConfig,
                                                VideoBackboneConfig)}

__all__ = ["DinoV2", "InverseForm", "InverseFormBackboneConfig", "Sam", "SwinV2",
           "SwinV2Backbone", "TimmBackbone", "TimmBackboneConfig", "VIDEO_BACKBONES",
           "VIDEO_CONFIGS", "VideoBackboneConfig", "VideoBackboneModule"]
