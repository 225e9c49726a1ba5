"""Training layer of the port: loss composition, the lockstep trainer,
checkpoints and metric reporting."""

from routeformer_torch.train.checkpoints import CheckpointManager
from routeformer_torch.train.logging import MetricsLogger
from routeformer_torch.train.losses import TrainingLosses, routeformer_training_loss
from routeformer_torch.train.trainer import ParallelTrainer, maybe_split_video

__all__ = ["CheckpointManager", "MetricsLogger", "ParallelTrainer", "TrainingLosses",
           "maybe_split_video", "routeformer_training_loss"]
