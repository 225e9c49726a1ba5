"""Training-loss composition of the port."""

from routeformer_torch.train.losses import TrainingLosses, routeformer_training_loss

__all__ = ["TrainingLosses", "routeformer_training_loss"]
