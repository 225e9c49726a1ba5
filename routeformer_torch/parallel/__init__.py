"""Train step of the port (one device; no mesh)."""

from routeformer_torch.parallel.train_step import make_train_step

__all__ = ["make_train_step"]
