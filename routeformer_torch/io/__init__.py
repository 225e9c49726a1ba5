"""Data layer of the port: synthetic batches, the GEM dataset and its
readers, the prefetching loader and the device frame store."""

from routeformer_torch.io.frame_store import ContentRing, hash_frames
from routeformer_torch.io.synthetic import (
    SyntheticDataset,
    synthetic_batch,
    synthetic_batch_numpy,
)


def __getattr__(name):
    # imported on first use: the dataset pulls in scipy and the readers
    if name == "GEMDataset":
        from routeformer_torch.io.dataset import GEMDataset

        return GEMDataset
    if name == "DreyeveDataset":
        from routeformer_torch.io.dataset_dreyeve import DreyeveDataset

        return DreyeveDataset
    if name == "DataLoader":
        from routeformer_torch.io.loader import DataLoader

        return DataLoader
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ContentRing", "DataLoader", "DreyeveDataset", "GEMDataset", "SyntheticDataset", "hash_frames",
           "synthetic_batch", "synthetic_batch_numpy"]
