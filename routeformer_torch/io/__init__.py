from routeformer_torch.io.synthetic import synthetic_batch, synthetic_batch_numpy

__all__ = ["synthetic_batch", "synthetic_batch_numpy"]
