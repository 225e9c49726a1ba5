"""Multi-model lockstep trainer on one device (counterpart of
``routeformer_tpu/train/trainer.py``).

A dict of candidate models trains on identical batches with one optimizer,
and is evaluated with the 5-forward Monte-Carlo protocol under a fixed
seed, with PCI-bucketed reporting (``train/metrics.py``). A step is the JAX
trainer's: one backward per model, its gradients left in its parameters,
then one clipped AdamW step over all trained models (the global gradient
clip spans every model). The math is that of one summed loss, but each
model's graph is freed by its own backward, so the step holds one model's
activations at a time, not all of them. Models whose name contains
``baseline`` are left out of the loss and out of the optimizer, so nothing
updates or decays their parameters (the JAX package zeroes their updates).

The Monte-Carlo eval: in eval mode the only stochastic part of a model is
the ProbSparse key sample. ``eval_batch_raw`` gives every ``ProbAttention``
(and so every fused Perceive stack) an explicit ``torch.Generator`` on the
trainer's device, reseeded to ``EVAL_SEED`` before each model's five
forwards on each batch, so two evaluations give the same bits. The draws
are torch's, not JAX's: the nnx stream is not reproduced draw for draw, so
MC-sampled metrics match the JAX package only where no key sample matters
(exhaustive ProbSparse, ``u == L``).

The epoch-10 backbone unfreeze flips ``unfreeze`` on every module whose
class sets ``epoch_unfreeze = True`` once ``epoch > unfreeze_epoch``; the
backbone then carries gradients (K1/K2 through autograd over their plain
f32 recompute) and its 1e-6 optimizer group starts to move it. A feature
cache serves frozen features, so the trainer refuses a cache together with
an unfreeze epoch when it is built.

``mesh=`` (a ``DeviceMesh`` of ``parallel.make_mesh``, one process per
rank) runs the same math as one device on the global batch: each rank takes
its row block of every batch (numpy leaves are global, tensors are its rows
already: a mesh loader's or the mesh memo's), every model's parameters are
laid out by the structural rule (``parallel.mesh.MeshParams``; ``fsdp``
also over ``data``) and gathered one unit at a time through its forward
and backward, the gradients (reduced during each model's backward) and
reported losses are the data shards' means, and one clipped
AdamW step over the blocks follows (the clip's norm is the whole
gradient's). With several data shards the per-batch decisions and the
training key samples come from a generator shared by every rank, the
per-row noise and masks from each data shard's own (the default generators
reseeded per shard), and what couples a batch's rows takes the global
batch (``parallel.mesh.share_streams``: the Informer's and PatchTST's
BatchNorm statistics, the dense loss's weight). The MC eval runs each rank's rows and gathers the per-sample
values in global row order before bucketing.
"""

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from routeformer_torch.io.loader import canonical
from routeformer_torch.models.layers.attention import ProbAttention
from routeformer_torch.ops.image import dequantize_videos
from routeformer_torch.optimizers.optimizer import Optimizer
from routeformer_torch.parallel import mesh as meshlib
from routeformer_torch.score.error import ade_per_sample, fde_per_sample
from routeformer_torch.train.losses import TrainingLosses, routeformer_training_loss
from routeformer_torch.train.metrics import GEM_QUARTILES, bucketed_eval_metrics
from routeformer_torch.utils import profiling
from routeformer_torch.utils.device import DeviceLike, resolve_device
from routeformer_torch.utils.logging import get_logger

logger = get_logger("trainer")

EVAL_SEED = 12345
MC_SAMPLES = 5


def set_mc_sampling(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every ``ProbAttention`` of ``model`` the Monte-Carlo eval's
    generator (fresh key samples in eval), or take it away (``None``)."""
    for module in model.modules():
        if isinstance(module, ProbAttention):
            module.mc_generator = generator


def maybe_split_video(batch: dict, enabled: bool = True) -> dict:
    """DR(eye)VE left-video split: the single view is cut into left and
    right halves. Returns a new dict and never writes the input's phase
    dicts; a batch that already has ``right_video`` passes unchanged."""
    if not enabled:
        return batch
    out = dict(batch)
    for phase in ("train", "target"):
        videos = batch.get(phase, {})
        if "left_video" not in videos or "right_video" in videos:
            continue
        videos = dict(videos)
        full = videos["left_video"]
        half = int(0.5 * full.shape[3])
        videos["right_video"] = full[:, :, :, half:]
        videos["left_video"] = full[:, :, :, :half]
        out[phase] = videos
    return out


def is_baseline(name: str) -> bool:
    return "baseline" in name


class ParallelTrainer:
    """Train all candidate models in lockstep with one optimizer.

    ``optimizer(module) -> optimizers.Optimizer`` builds the optimizer over
    the module dict of the trained models, e.g.
    ``lambda m: build_optimizer(m, learning_rate=1e-5, ...)``. The models
    move to ``device`` (CUDA by default; raises without it)."""

    def __init__(self, models: Dict[str, nn.Module],
                 optimizer: Callable[[nn.Module], Optimizer], config,
                 quartiles: Optional[Dict[str, float]] = None,
                 loss_fn: Optional[Callable] = None, mesh=None,
                 min_shard_dim: int = 512, unfreeze_epoch: Optional[int] = 10,
                 feature_cache_active: bool = False, device: DeviceLike = None,
                 fsdp: bool = False):
        if mesh is not None:
            meshlib.check_mesh(mesh)
        if feature_cache_active and unfreeze_epoch is not None:
            raise ValueError(
                f"feature_cache_active with unfreeze_epoch={unfreeze_epoch}: cached "
                "runs keep serving frozen features past the unfreeze boundary and "
                "would silently diverge. Pass unfreeze_epoch=None (train fully "
                "frozen) or disable the embedding cache.")
        self.device = resolve_device(device)
        self.model_names = list(models)
        self.models = nn.ModuleDict(models).to(self.device).train()
        self.config = config
        self.quartiles = quartiles or GEM_QUARTILES
        self.losses = TrainingLosses.from_config(config)
        self._loss_fn = loss_fn or self._default_loss_fn
        self.unfreeze_epoch = unfreeze_epoch
        self.feature_cache_active = feature_cache_active
        self._unfrozen = False
        self.trained = nn.ModuleDict(
            {n: m for n, m in self.models.items() if not is_baseline(n)})
        self.mesh = mesh
        self.layouts = {}
        self.shared_generator = None
        if mesh is not None:
            self._join_mesh(min_shard_dim, fsdp)
        has_params = any(True for _ in self.trained.parameters())
        self.optimizer = optimizer(self.trained) if has_params else None
        if self.optimizer is not None:
            self.optimizer.mesh = mesh
        self.eval_generator = torch.Generator(device=self.device)
        self.grad_norm: Optional[torch.Tensor] = None  # the last step's, before the clip
        self.epoch = 0

    def _join_mesh(self, min_shard_dim: int, fsdp: bool) -> None:
        """Lay every model out on the mesh (rank 0's weights) and, with
        several data shards, split the random streams: one shared by every
        rank, and each data shard's own default generators."""
        for name, model in self.models.items():
            self.layouts[name] = meshlib.MeshParams(model, self.mesh, min_shard_dim, fsdp)
        self.shared_generator = meshlib.share_streams(self.models.values(), self.mesh,
                                                      self.device)

    def _gathered(self, name: str):
        """The model's per-unit gathers while the body runs
        (``MeshParams.gathered``; a no-op without a mesh)."""
        layout = self.layouts.get(name)
        return contextlib.nullcontext() if layout is None else layout.gathered()

    def _place(self, part: dict) -> dict:
        """A phase of a batch on the trainer's device, videos dequantized.
        Numpy leaves (the synthetic sets, a loader without ``to_device``)
        are copied here from pageable memory, float64 as float32 as JAX
        places them; tensors already on the device (a placing loader's)
        are used as they are, with no copy. On a mesh a numpy leaf is the
        global batch and this rank takes its row block."""
        out = {}
        with profiling.span("rf.place"):
            for k, v in part.items():
                if self.mesh is not None:
                    v = meshlib.place_batch_leaf(v, self.mesh, self.device)
                elif isinstance(v, np.ndarray):
                    v = torch.from_numpy(np.ascontiguousarray(canonical(v)))
                out[k] = v.to(self.device)
            return dequantize_videos(out)

    def _default_loss_fn(self, name, model, inp, tgt, epoch):
        return routeformer_training_loss(model, inp, tgt, epoch, self.losses)

    def _apply_unfreeze(self) -> None:
        """Flip ``unfreeze`` on the opted-in backbone modules when the
        epoch crosses ``unfreeze_epoch``."""
        if self.unfreeze_epoch is None:
            return
        want = self.epoch > self.unfreeze_epoch
        if want == self._unfrozen:
            return
        if want and self.feature_cache_active:
            raise RuntimeError(
                f"epoch {self.epoch}: the backbone unfreeze was crossed while a "
                "feature cache is active; cached runs would keep serving frozen "
                "features. Disable the cache or pass unfreeze_epoch=None.")
        for module in self.models.modules():
            if getattr(type(module), "epoch_unfreeze", False):
                module.unfreeze = want
        self._unfrozen = want
        logger.info("epoch %d: video-backbone unfreeze -> %s", self.epoch, want)

    def training_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One lockstep update on one batch: each trained model's loss and
        its backward in turn, then one clipped AdamW step over all of them.
        Returns detached ``train_{metric}_{model}`` and ``train_total_loss``
        (the sum of the losses)."""
        # The root span closes after the step's locals, and so its autograd
        # graphs, are gone.
        with profiling.span("rf.train_step"):
            return self._training_step(batch)

    def _training_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        self._apply_unfreeze()
        inp, tgt = self._place(batch["train"]), self._place(batch["target"])
        metrics = {}
        total = torch.zeros((), device=self.device)
        if self.optimizer is not None:
            self.optimizer.zero_grad()
        for name, model in self.trained.items():
            with self._gathered(name):
                with profiling.span("rf.loss"):
                    loss, model_metrics = self._loss_fn(name, model, inp, tgt, self.epoch)
                with profiling.span("rf.backward"):
                    loss.backward()
                    if name in self.layouts:
                        self.layouts[name].reduce_grads()
            total = total + loss.detach()
            for k, v in model_metrics.items():
                metrics[f"train_{k}_{name}"] = v.detach()
        metrics["train_total_loss"] = total
        if self.mesh is not None:
            metrics = meshlib.mean_over_data(metrics, self.mesh)
        if self.optimizer is not None:
            with profiling.span("rf.optimizer"):
                self.grad_norm = self.optimizer.step().detach()
        return metrics

    def eval_batch_raw(self, batch: dict, names: Optional[list] = None):
        """``(pcis, {model: (losses, ades, fdes)})``, one value per sample:
        each model's prediction is the mean of ``MC_SAMPLES`` eval forwards
        with fresh key samples from the generator reseeded to ``EVAL_SEED``.
        ``names`` evaluates only those models (default: all)."""
        inp = self._place(batch["train"])
        leaves = {k: v if isinstance(v, torch.Tensor) else np.asarray(v)
                  for k, v in (("gps", batch["target"]["gps"]), ("pci", batch["pci"]))}
        leaves = self._place(leaves)
        target_gps, pcis = leaves["gps"].float(), leaves["pci"].float()
        raw = {}
        for name in self.model_names if names is None else names:
            model = self.models[name]
            was_training = model.training
            model.eval()
            set_mc_sampling(model, self.eval_generator)
            try:
                self.eval_generator.manual_seed(EVAL_SEED)
                with torch.no_grad(), self._gathered(name):
                    preds = []
                    for _ in range(MC_SAMPLES):
                        out = model(inp)
                        preds.append(out[0] if isinstance(out, tuple) else out)
                    future = torch.stack(preds).mean(dim=0)
                    losses = torch.stack([
                        self.losses.trajectory_loss(future[i:i + 1], target_gps[i:i + 1],
                                                    self.epoch)
                        for i in range(future.shape[0])])
                    raw[name] = tuple(self._rows(x) for x in (
                        losses, ade_per_sample(future, target_gps),
                        fde_per_sample(future, target_gps)))
            finally:
                set_mc_sampling(model, None)
                model.train(was_training)
        return self._rows(pcis), raw

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """Per-sample values on the CPU, gathered in global row order on a
        mesh."""
        if self.mesh is not None:
            x = meshlib.gather_rows(x, self.mesh)
        return x.cpu()

    def evaluate(self, batches, split: str = "val") -> Dict[str, torch.Tensor]:
        """Epoch-level eval: per-sample values over every batch, bucketed
        once (the sample-weighted epoch mean)."""
        all_pcis, acc = [], {name: [] for name in self.model_names}
        for batch in batches:
            pcis, raw = self.eval_batch_raw(batch)
            all_pcis.append(pcis)
            for name, values in raw.items():
                acc[name].append(values)
        if not all_pcis:
            return {}
        pcis = torch.cat(all_pcis)
        metrics = {}
        for name in self.model_names:
            losses, ades, fdes = (torch.cat([t[i] for t in acc[name]]) for i in range(3))
            metrics.update(bucketed_eval_metrics(f"{split}_{name}", pcis, losses, ades,
                                                 fdes, self.quartiles))
        return metrics

    def fit(self, train_batches, val_batches=None, epochs: int = 1,
            log_every: int = 10, on_metrics: Optional[Callable] = None):
        """Epoch loop over batch iterables; returns the val metrics of each
        epoch. ``epoch`` ends one past the last trained epoch."""
        history = []
        for epoch in range(self.epoch, self.epoch + epochs):
            self.epoch = epoch
            for i, batch in enumerate(train_batches):
                metrics = self.training_step(batch)
                if i % log_every == 0:
                    logger.info("epoch %d step %d loss %.4f", epoch, i,
                                float(metrics["train_total_loss"]))
                    if on_metrics:
                        on_metrics("train", epoch, i, metrics)
            if val_batches is not None:
                val_metrics = self.evaluate(val_batches, "val")
                history.append(val_metrics)
                if on_metrics:
                    on_metrics("val", epoch, 0, val_metrics)
            self.epoch = epoch + 1
        return history
