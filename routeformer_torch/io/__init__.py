from routeformer_torch.io.frame_store import ContentRing, hash_frames
from routeformer_torch.io.synthetic import (
    SyntheticDataset,
    synthetic_batch,
    synthetic_batch_numpy,
)

__all__ = ["ContentRing", "SyntheticDataset", "hash_frames", "synthetic_batch",
           "synthetic_batch_numpy"]
