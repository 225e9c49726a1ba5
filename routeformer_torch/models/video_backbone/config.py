"""Video backbone config (the port's copy of
``routeformer_tpu/models/video_backbone/config.py:TimmBackboneConfig``)."""

from dataclasses import dataclass
from typing import Optional

from routeformer_torch.utils.config import BaseConfig


@dataclass
class TimmBackboneConfig(BaseConfig):
    cache_dir: Optional[str] = None
    train_backbone: bool = False
    cache_enabled: bool = False
    # The embedding cache's knobs (``video_backbone/cache.py``).
    cache_module_hash: Optional[str] = None
    max_memory_cache_size: float = 20e9
    cache_dtype: str = "bfloat16"
    pad_to_square: bool = True
    model_type: Optional[str] = None
    # Encoder compute dtype; parameters stay float32.
    compute_dtype: str = "bfloat16"
    # "exact" (erf) or "tanh". SwinV2: tanh blocks run the fused block
    # kernel (K1), exact blocks window attention (K2) with plain Linear and
    # LayerNorm. ViT: the gelu of the blocks' MLP.
    gelu: str = "exact"

    def __post_init__(self):
        if self.train_backbone:
            raise NotImplementedError("backbone training is not ported yet")
