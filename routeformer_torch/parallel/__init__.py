"""Train and eval steps of the port (one device; no mesh)."""

from routeformer_torch.parallel.train_step import make_eval_step, make_train_step

__all__ = ["make_eval_step", "make_train_step"]
