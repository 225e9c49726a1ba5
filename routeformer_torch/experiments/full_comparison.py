"""Full-comparison training driver (counterpart of
``experiments/full_comparison.py``).

    MODEL_SET=flagship python -m routeformer_torch.experiments.full_comparison

Builds the candidate models, trains them in lockstep on identical batches
with one optimizer (``train/trainer.ParallelTrainer``), evaluates every
epoch with the Monte-Carlo, PCI-bucketed protocol, keeps best-ADE
checkpoints and, with ``SAVE_EVERY_STEPS``, a snapshot for exact resume
(``train/checkpoints.CheckpointManager``). Configuration is by the JAX
driver's environment variables, read when ``main`` runs:

  DATASET=DREYEVE|<other: GEM>  DEBUG=0|1  EPOCHS  MIN_PCI  OUTPUT_FPS
  BATCH_SIZE  RESULTS_DIR (default build/full_comparison)  MODEL_SET
  DISCOUNTED_FACTOR=default|<other: {0: 1.0}>  LIMIT_TRAIN_BATCHES
  COMPUTE_DTYPE=bfloat16|float32  USE_EMBEDDING_CACHE=0|1|host|device
  RESUME=0|1  SAVE_EVERY_STEPS  ROUTEFORMER_FORCE_CPU=1 (run on the CPU;
  otherwise CUDA, and without it the driver raises)

Only ``MODEL_SET=flagship`` is ported: the flagship Routeformer (SwinV2-base
with tanh gelu, whose blocks run K1, as ``flagship.flagship_config``; the
JAX driver's exact-gelu SwinV2 would take the unfused block). ``gps`` and
``full`` need the rest of the model zoo, a ``*_DATASET_DIR`` the data
layer, ``USE_PATCHTST_BACKBONE=1`` PatchTST and ``FSDP=1`` the multi-card
mesh: each raises ``NotImplementedError`` naming its ``ROADMAP.md`` item.
The data are the synthetic GEM-geometry batches of ``io/synthetic.py``.
"""

import functools
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
INPUT_LENGTH_SECONDS = 8
TARGET_LENGTH_SECONDS = 6
VIDEO_FPS = 1
GAZE_FPS = 1
FLAGSHIP = "Routeformer_with_video_with_gaze_swinv2"


@dataclass
class Settings:
    """The driver's environment variables, with the JAX driver's defaults."""

    dataset: str = "DREYEVE"
    debug: bool = False
    epochs: int = 200
    min_pci: float = 20.0
    output_fps: int = 5
    batch_size: int = 16
    results_dir: Path = ROOT / "build" / "full_comparison"
    model_set: str = "full"
    discount_factor: dict = field(default_factory=lambda: {0: 0.97, 100: 0.98, 200: 0.99})
    limit_train_batches: float = 1.0
    compute_dtype: str = "bfloat16"
    use_embedding_cache: str = "0"
    resume: bool = False
    save_every_steps: int = 0
    force_cpu: bool = False
    dataset_dir: Optional[str] = None

    @classmethod
    def from_env(cls, env=None) -> "Settings":
        env = os.environ if env is None else env
        debug = env.get("DEBUG", "0") == "1"
        dataset = env.get("DATASET", "DREYEVE")
        if env.get("USE_PATCHTST_BACKBONE", "0") == "1":
            raise NotImplementedError(
                "USE_PATCHTST_BACKBONE=1: PatchTST is not ported (ROADMAP.md §1 item 7)")
        if env.get("FSDP", "0") == "1":
            raise NotImplementedError(
                "FSDP=1: the multi-card mesh is not ported (ROADMAP.md §1 item 6)")
        cache = env.get("USE_EMBEDDING_CACHE", "0")
        if cache not in ("0", "1", "host", "device"):
            raise ValueError(f"USE_EMBEDDING_CACHE={cache!r}: expected 0, 1, host or device")
        return cls(
            dataset=dataset, debug=debug,
            epochs=int(env.get("EPOCHS", 1 if debug else 200)),
            min_pci=float(env.get("MIN_PCI", 20)),
            output_fps=int(env.get("OUTPUT_FPS", 5)),
            batch_size=int(env.get("BATCH_SIZE", 2 if debug else 16)),
            results_dir=Path(env.get("RESULTS_DIR", ROOT / "build" / "full_comparison")),
            model_set=env.get("MODEL_SET", "full"),
            discount_factor=({0: 0.97, 100: 0.98, 200: 0.99}
                             if env.get("DISCOUNTED_FACTOR", "default") == "default"
                             else {0: 1.0}),
            limit_train_batches=float(env.get("LIMIT_TRAIN_BATCHES", 1)),
            compute_dtype=env.get("COMPUTE_DTYPE", "bfloat16"),
            use_embedding_cache=cache,
            resume=env.get("RESUME", "0") == "1",
            save_every_steps=int(env.get("SAVE_EVERY_STEPS", "0")),
            force_cpu=env.get("ROUTEFORMER_FORCE_CPU", "0") == "1",
            dataset_dir=env.get("DREYEVE_DATASET_DIR" if dataset == "DREYEVE"
                                else "ROUTEFORMER_DATASET_DIR"),
        )

    @property
    def seq_len(self) -> int:
        return INPUT_LENGTH_SECONDS * self.output_fps

    @property
    def pred_len(self) -> int:
        return TARGET_LENGTH_SECONDS * self.output_fps

    @property
    def quartiles(self) -> dict:
        from routeformer_torch.train.metrics import DREYEVE_QUARTILES, GEM_QUARTILES

        return DREYEVE_QUARTILES if self.dataset == "DREYEVE" else GEM_QUARTILES


def routeformer_config(s: Settings):
    """The flagship's config under the driver's settings (``DEBUG`` cuts
    its widths as the JAX driver does)."""
    from routeformer_torch.models import RouteformerConfig
    from routeformer_torch.models.gps_backbone import GPSBackboneConfig
    from routeformer_torch.models.video_backbone import TimmBackboneConfig

    gps = dict(seq_len=s.seq_len, label_len=s.seq_len, pred_len=s.pred_len,
               embed="timeF", freq="m", moving_avg=25, factor=4, distil=True,
               dropout=0.0, activation="relu", individual=False,
               d_model=832, n_heads=8, e_layers=6, d_layers=1, d_ff=832 * 4)
    widths = dict(image_embedding_size=64, encoder_hidden_size=64, encoder_layers=8,
                  encoder_d_ff=64 * 4)
    model_type = "swinv2_base_window12to16_192to256.ms_in22k_ft_in1k"
    if s.debug:
        gps.update(d_model=64, e_layers=2, d_ff=128)
        widths = dict(image_embedding_size=16, encoder_hidden_size=16, encoder_layers=2,
                      encoder_d_ff=32)
        model_type = "swinv2_tiny_test"
    return RouteformerConfig(
        gps_backbone_config=GPSBackboneConfig(**gps),
        video_backbone_config=TimmBackboneConfig(
            model_type=model_type, train_backbone=False, cache_enabled=False,
            pad_to_square=True, gelu="tanh"),
        discount_factor=s.discount_factor, epsilon=1.0, visual_epsilon=0.3,
        normalize_motion=False, rotate_motion=s.dataset == "DREYEVE",
        decoder_mode="smart", compute_dtype=s.compute_dtype,
        with_video=True, with_gaze=True, video_fps=VIDEO_FPS, gaze_fps=GAZE_FPS,
        output_fps=s.output_fps, dense_prediction=True, dense_loss_ratio=0.5,
        view_dropout=0.6, gaze_dropout=0.2, motion_noise=0.0, feature_dropout=0.05,
        encoder_heads=8, cross_modal_decoder_heads=8, cross_modal_decoder_layers=2,
        **widths,
    )


def build_models(s: Settings) -> dict:
    """The candidate models: the flagship alone (seeded weights)."""
    from routeformer_torch.flagship import init_weights
    from routeformer_torch.models import Routeformer
    from routeformer_torch.models.gps_backbone import Informer
    from routeformer_torch.models.video_backbone import SwinV2Backbone

    if s.model_set != "flagship":
        raise NotImplementedError(
            f"MODEL_SET={s.model_set}: the gps and full sets need the rest of the "
            "model zoo (ROADMAP.md §1 item 7); MODEL_SET=flagship is ported")
    model = Routeformer(routeformer_config(s), gps_backbone=Informer,
                        video_backbone=SwinV2Backbone)
    init_weights(model, seed=0)
    return {FLAGSHIP: model}


def build_data(s: Settings, with_video: bool = True):
    """``(train, val)`` synthetic datasets (a real dataset directory needs
    the data layer, which is not ported)."""
    from routeformer_torch.io.synthetic import SyntheticDataset

    if s.dataset_dir and Path(s.dataset_dir).exists():
        raise NotImplementedError(
            f"{s.dataset_dir}: the GEM/DR(eye)VE data layer is not ported "
            "(ROADMAP.md §1 item 4); unset the dataset directory to train on "
            "synthetic batches")
    common = dict(batch_size=s.batch_size, seq_len=s.seq_len, pred_len=s.pred_len,
                  fps=s.output_fps, with_video=with_video, with_gaze=with_video,
                  frame_hw=(24, 32) if s.debug else (54, 96))
    return (SyntheticDataset(n_batches=2 if s.debug else 64, seed=1, **common),
            SyntheticDataset(n_batches=1 if s.debug else 8, seed=2, **common))


def build_precompute(s: Settings, models: dict, device):
    """The embedding cache's batch transform for ``USE_EMBEDDING_CACHE``
    (None when off): ``device`` the device memo, ``1``/``host`` the host
    RAM cache."""
    if s.use_embedding_cache == "0":
        return None
    from routeformer_torch.models.video_backbone.cache import (
        DeviceVideoFeaturePrecomputer,
        VideoFeaturePrecomputer,
    )

    model = models[FLAGSHIP]
    if s.use_embedding_cache == "device":
        return DeviceVideoFeaturePrecomputer(model, device=device)
    return VideoFeaturePrecomputer(model, device=device)


def build_trainer(s: Settings, models: dict, device):
    """The lockstep trainer with the JAX driver's optimizer (AdamW 1e-5,
    weight decay 1e-4, backbone 1e-6, warmup 2 epochs, clip 2.5); an
    embedding cache keeps the backbone frozen for the whole run."""
    from routeformer_torch.optimizers import build_optimizer
    from routeformer_torch.train.trainer import ParallelTrainer

    cache_on = s.use_embedding_cache != "0"
    return ParallelTrainer(
        models,
        functools.partial(build_optimizer, learning_rate=1e-5, weight_decay=1e-4,
                          video_backbone_lr=1e-6, warmup_epochs=2, max_epochs=s.epochs,
                          gradient_clip_val=2.5),
        models[FLAGSHIP].configs, quartiles=s.quartiles, feature_cache_active=cache_on,
        unfreeze_epoch=None if cache_on else 10, device=device,
    )


def make_prepare(precompute: Optional[Callable]) -> Callable:
    def prepare(batch: dict) -> dict:
        if precompute is None:
            return batch
        return dict(batch, train=precompute(batch["train"]),
                    target=precompute(batch["target"]))

    return prepare


def run_epochs(trainer, ckpt, metrics_logger, train_data, val_data, prepare, *,
               epochs: int, start_epoch: int = 0, start_batch: int = 0,
               save_every: int = 0, max_train_batches: Optional[int] = None) -> list:
    """The epoch loop: train steps (a snapshot every ``save_every`` steps),
    the epoch's MC eval, best-ADE checkpoints, and a snapshot at the epoch's
    end when snapshots are on. Returns one record per epoch."""
    history = []
    names = trainer.model_names
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        trainer.epoch = epoch
        skip = start_batch if epoch == start_epoch else 0
        n_train = len(train_data)
        stop = n_train if max_train_batches is None else min(n_train, max_train_batches)
        for i in range(skip, stop):
            metrics = trainer.training_step(prepare(train_data[i]))
            if i % 10 == 0:
                metrics_logger.log(metrics, epoch * n_train + i, "train")
            if save_every and (i + 1) % save_every == 0:
                ckpt.save_latest(trainer, epoch, next_batch=i + 1)
        val_metrics = trainer.evaluate((prepare(val_data[i]) for i in range(len(val_data))),
                                       "val")
        metrics_logger.log(val_metrics, epoch, "val")
        ckpt.maybe_save(trainer, val_metrics, epoch)
        if save_every:
            ckpt.save_latest(trainer, epoch + 1, next_batch=0)
        history.append({"epoch": epoch, "seconds": time.perf_counter() - t0,
                        "val": val_metrics})
        print(f"epoch {epoch}: " + ", ".join(
            f"{n}={float(val_metrics.get(f'val_{n}_ade', np.nan)):.3f}" for n in names[:3]),
            flush=True)
    return history


def main(env=None) -> list:
    """Train as the environment says; returns ``run_epochs``' records."""
    from routeformer_torch.train.checkpoints import CheckpointManager
    from routeformer_torch.train.logging import MetricsLogger
    from routeformer_torch.utils.device import resolve_device
    from routeformer_torch.utils.logging import set_logger_config

    s = Settings.from_env(env)
    set_logger_config("DEBUG" if s.debug else "ERROR")
    device = resolve_device("cpu" if s.force_cpu else None)
    models = build_models(s)
    config = models[FLAGSHIP].configs
    if s.use_embedding_cache != "0":
        print("USE_EMBEDDING_CACHE active: video backbones stay frozen for the "
              "entire run (epoch-10 unfreeze disabled)")
    trainer = build_trainer(s, models, device)
    ckpt = CheckpointManager(s.results_dir / "checkpoints")
    metrics_logger = MetricsLogger(s.results_dir / "logs",
                                   experiment=f"{s.dataset.lower()}_full_comparison",
                                   config=config.to_dict())
    train_data, val_data = build_data(s)
    prepare = make_prepare(build_precompute(s, models, device))
    start_epoch, start_batch = 0, 0
    if s.resume:
        latest = ckpt.restore_latest(trainer)
        if latest is not None:
            start_epoch, start_batch = latest
            print(f"resumed latest snapshot: epoch {start_epoch} batch {start_batch}")
        else:
            start_epoch = ckpt.restore_all(trainer)
            print(f"resumed from best checkpoints at epoch {start_epoch}")
    try:
        history = run_epochs(
            trainer, ckpt, metrics_logger, train_data, val_data, prepare,
            epochs=s.epochs, start_epoch=start_epoch, start_batch=start_batch,
            save_every=s.save_every_steps,
            max_train_batches=(int(len(train_data) * s.limit_train_batches)
                               if s.limit_train_batches < 1 else None),
        )
    finally:
        metrics_logger.close()
    print("best:", ckpt.best)
    return history


if __name__ == "__main__":
    main()
