"""External baselines of the comparison (counterpart of
``routeformer_tpu/baselines``): AutoBot-Ego, adapted GIMO and the
multimodal Transformer."""

from routeformer_torch.baselines.autobots import AutoBotAdapted, AutoBotEgo
from routeformer_torch.baselines.gimo import AdaptedGIMO
from routeformer_torch.baselines.multimodal_transformer import MultiModalTransformer

__all__ = ["AdaptedGIMO", "AutoBotAdapted", "AutoBotEgo", "MultiModalTransformer"]
