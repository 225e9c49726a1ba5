"""Full-comparison training driver (counterpart of
``experiments/full_comparison.py``).

    MODEL_SET=full python -m routeformer_torch.experiments.full_comparison

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
  RESUME=0|1  SAVE_EVERY_STEPS  USE_PATCHTST_BACKBONE=0|1
  ROUTEFORMER_DATASET_DIR (DATASET=GEM) / DREYEVE_DATASET_DIR  and
  ROUTEFORMER_DATASET_CACHE_DIR / DREYEVE_DATASET_CACHE_DIR
  VIDEO_DTYPE=uint8|float16  USE_MEMORY_CACHE=0|1  MAX_MEMORY_CACHE_SIZE
  H2D_DEDUP=1|0  LOADER_PRODUCERS  ENABLE_PCI_SPLIT=0|1 (DREYEVE)
  PCI_SPLIT_N_SAMPLES_PER_BIN  ENABLE_LEFT_VIDEO_SPLIT=1|0 (DREYEVE)
  ROUTEFORMER_FORCE_CPU=1 (run on the CPU; otherwise CUDA, and without it
  the driver raises)  N_MODEL_SHARDS (default 1)  FSDP=0|1

``MODEL_SET`` builds the JAX driver's models with its names, classes,
configs (``driver_configs``) and seeds: ``flagship`` the SwinV2 Routeformer
with video and gaze; ``gps`` AutoBotEgo, the video-less Routeformers over
the Informer, Transformer, DLinear and NLinear, and the stationary and
linear baselines; ``full`` (the default) both and the autoregressive,
scene-less and gaze-less variants, AdaptedGIMO and the
MultiModalTransformer. ``USE_PATCHTST_BACKBONE=1`` puts PatchTST under the
flagship. The SwinV2 blocks use the exact gelu, as the JAX driver's do:
K1 with its erf epilogue runs them in the frozen steps and the eval
forwards, the unfused block (K2 for window attention) where the backbone
trains.

With ``ROUTEFORMER_DATASET_DIR`` (``DATASET=GEM``) or
``DREYEVE_DATASET_DIR`` (``DATASET=DREYEVE``, the default) set to a
directory, the data are that recording's (``build_data``, the JAX driver's
``:286-353``): ``io/dataset.GEMDataset`` or ``io/dataset_dreyeve.
DreyeveDataset`` splits (train at ``min_pci=0``, DR(eye)VE's with the
PCI-balanced bins under ``ENABLE_PCI_SPLIT=1``, which replace shuffling;
val at ``MIN_PCI``) behind ``io/loader.DataLoader``s that place each batch
on the card from the producer thread (pinned, non-blocking, on a side
stream) and, with ``H2D_DEDUP=1`` (the default), ship each distinct video
frame once through the frame store. DR(eye)VE's single garmin view is cut
into left and right halves (``ENABLE_LEFT_VIDEO_SPLIT=1``, the default,
``train/trainer.maybe_split_video``): on the placed batch, as two views of
its tensor, or before the embedding cache's host stage when that is on.
Without a directory the data are the synthetic GEM-geometry batches of
``io/synthetic.py``.

Several cards (the JAX driver's mesh, ``:386-401``): one process per card,

    torchrun --nproc_per_node=N -m routeformer_torch.experiments.full_comparison

or a plain launch on a machine with several visible cards, which spawns one
rank per card itself (it never trains on one card of several). The ranks
form a ``(data, model)`` mesh with ``n_data = ranks // N_MODEL_SHARDS``
(``parallel/mesh.py``; NCCL, or gloo under ``ROUTEFORMER_FORCE_CPU=1``);
``BATCH_SIZE`` must divide by ``n_data``; ``FSDP=1`` also shards the large
parameters and their AdamW moments over ``data``. Each rank reads and
trains on its row block of every batch; only rank 0 prints, writes the
metrics stream and the logs, and writes the checkpoints (every rank joins
their gathers). With one process (``WORLD_SIZE`` unset or 1) there is no
mesh, as the JAX driver has none on one device.
"""

import functools
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
STEP_SIZE_SECONDS = 2
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
    use_patchtst_backbone: bool = False
    dataset_cache_dir: Optional[str] = None
    video_dtype: str = "uint8"
    use_memory_cache: bool = False
    max_memory_cache_size: int = int(100e9)
    h2d_dedup: bool = True
    loader_producers: Optional[int] = None
    gopro_scaling_factor: float = 0.4  # the JAX driver's: DREYEVE 0.4, GEM 0.1
    front_scaling_factor: float = 1 / 3.0  # DREYEVE 1/3, GEM 0.3
    enable_pci_split: bool = False  # DREYEVE only
    pci_split_n_samples_per_bin: int = 200
    enable_left_video_split: bool = True
    n_model_shards: int = 1
    fsdp: bool = False

    @classmethod
    def from_env(cls, env=None) -> "Settings":
        env = os.environ if env is None else env
        debug = env.get("DEBUG", "0") == "1"
        dataset = env.get("DATASET", "DREYEVE")
        cache = env.get("USE_EMBEDDING_CACHE", "0")
        if cache not in ("0", "1", "host", "device"):
            raise ValueError(f"USE_EMBEDDING_CACHE={cache!r}: expected 0, 1, host or device")
        prefix = "DREYEVE" if dataset == "DREYEVE" else "ROUTEFORMER"
        dataset_dir = env.get(f"{prefix}_DATASET_DIR")
        producers = env.get("LOADER_PRODUCERS")
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
            use_patchtst_backbone=env.get("USE_PATCHTST_BACKBONE", "0") == "1",
            dataset_dir=dataset_dir,
            dataset_cache_dir=env.get(f"{prefix}_DATASET_CACHE_DIR"),
            video_dtype=env.get("VIDEO_DTYPE", "uint8"),
            use_memory_cache=env.get("USE_MEMORY_CACHE", "0") == "1",
            max_memory_cache_size=int(float(env.get("MAX_MEMORY_CACHE_SIZE", "100e9"))),
            h2d_dedup=env.get("H2D_DEDUP", "1") == "1",
            loader_producers=None if producers is None else int(producers),
            gopro_scaling_factor=0.4 if dataset == "DREYEVE" else 0.1,
            front_scaling_factor=1 / 3.0 if dataset == "DREYEVE" else 0.3,
            enable_pci_split=dataset == "DREYEVE" and env.get("ENABLE_PCI_SPLIT", "0") == "1",
            pci_split_n_samples_per_bin=int(env.get("PCI_SPLIT_N_SAMPLES_PER_BIN", 200)),
            enable_left_video_split=env.get("ENABLE_LEFT_VIDEO_SPLIT", "1") == "1",
            n_model_shards=int(env.get("N_MODEL_SHARDS", "1")),
            fsdp=env.get("FSDP", "0") == "1",
        )

    @property
    def seq_len(self) -> int:
        return INPUT_LENGTH_SECONDS * self.output_fps

    @property
    def pred_len(self) -> int:
        return TARGET_LENGTH_SECONDS * self.output_fps

    @property
    def with_video(self) -> bool:
        return self.model_set in ("full", "flagship")

    @property
    def recording(self) -> bool:
        """Whether the data come from a recording (a ``*_DATASET_DIR`` that
        exists), not the synthetic batches."""
        return bool(self.dataset_dir) and Path(self.dataset_dir).exists()

    @property
    def split_video(self) -> bool:
        """The JAX driver's rule for DR(eye)VE's left-video split."""
        return (self.dataset == "DREYEVE" and self.with_video and self.enable_left_video_split
                and self.recording)

    @property
    def embedding_cache_on(self) -> bool:
        """The JAX driver's rule: the embedding cache serves the flagship
        set only."""
        return self.use_embedding_cache != "0" and self.model_set == "flagship"

    @property
    def quartiles(self) -> dict:
        from routeformer_torch.train.metrics import DREYEVE_QUARTILES, GEM_QUARTILES

        return DREYEVE_QUARTILES if self.dataset == "DREYEVE" else GEM_QUARTILES


def mesh_shape(s: Settings, world: int):
    """``(n_data, n_model)`` of the JAX driver's mesh over ``world`` ranks;
    exits with its message when ``BATCH_SIZE`` does not divide by
    ``n_data``."""
    n_model = s.n_model_shards
    n_data = world // n_model
    if s.batch_size % n_data != 0:
        raise SystemExit(
            f"BATCH_SIZE={s.batch_size} must be divisible by the data-"
            f"parallel degree {n_data} (devices={world}, "
            f"N_MODEL_SHARDS={n_model})")
    return n_data, n_model


def driver_configs(s: Settings) -> dict:
    """The JAX driver's configs (``experiments/full_comparison.py``), field
    for field, by their names there. ``DEBUG`` cuts the widths and takes the
    ``vit_tiny_test`` SwinV2 preset as the JAX driver does. The SwinV2 uses
    the exact gelu, as the JAX driver's does: its blocks run K1 with the
    erf epilogue where the backbone is frozen and the unfused block (K2 for
    window attention) where it trains; the tanh-gelu flagship of
    ``flagship.py`` is serving's and ``build_flagship_training``'s."""
    from routeformer_torch.models import RouteformerConfig
    from routeformer_torch.models.gps_backbone import (
        GPSBackboneConfig,
        LinearBackboneConfig,
        PatchTSTBackboneConfig,
    )
    from routeformer_torch.models.video_backbone import TimmBackboneConfig

    gps = dict(seq_len=s.seq_len, label_len=s.seq_len, pred_len=s.pred_len,
               embed="timeF", freq="m", moving_avg=25, factor=4, distil=True,
               dropout=0.0, activation="relu", individual=False,
               d_model=832, n_heads=8, e_layers=6, d_layers=1, d_ff=832 * 4)
    if s.debug:
        gps.update(d_model=64, e_layers=2, d_ff=128)
    c = {"GPS_BACKBONE_CONFIG": GPSBackboneConfig(**gps),
         "LINEAR_BACKBONE_CONFIG": LinearBackboneConfig(**gps, kernel_size=25),
         "PATCHTST_BACKBONE_CONFIG": PatchTSTBackboneConfig(
             **gps, fc_dropout=0.1, head_dropout=0.0, patch_len_ratio=0.25,
             stride_ratio=0.125, padding_patch="end", revin=True, affine=False,
             subtract_last=False, decomposition=False, kernel_size=25)}
    c["ROUTEFORMER_CONFIG"] = RouteformerConfig(
        gps_backbone_config=c["GPS_BACKBONE_CONFIG"], lr=1e-5, wd=1e-4,
        discount_factor=s.discount_factor, epsilon=1.0, visual_epsilon=0.3,
        optimizer="AdamW", batch_size=s.batch_size, min_pci=s.min_pci,
        step_size=STEP_SIZE_SECONDS, epochs=s.epochs, output_fps=s.output_fps,
        gopro_scaling_factor=s.gopro_scaling_factor,
        front_scaling_factor=s.front_scaling_factor, normalize_motion=False,
        rotate_motion=s.dataset == "DREYEVE", decoder_mode="smart",
        compute_dtype=s.compute_dtype)
    c["SWINV2_BACKBONE_CONFIG"] = TimmBackboneConfig(
        model_type="vit_tiny_test" if s.debug
        else "swinv2_base_window12to16_192to256.ms_in22k_ft_in1k",
        train_backbone=False, cache_enabled=False, pad_to_square=True)
    swinv2 = c["ROUTEFORMER_CONFIG"].override(
        video_backbone_config=c["SWINV2_BACKBONE_CONFIG"], with_video=True,
        video_fps=VIDEO_FPS, gaze_fps=GAZE_FPS, dense_prediction=True,
        dense_loss_ratio=0.5, image_embedding_size=64, view_dropout=0.6, gaze_dropout=0.2,
        motion_noise=0.0, feature_dropout=0.05, encoder_hidden_size=64, encoder_heads=8,
        encoder_layers=8, encoder_d_ff=64 * 4, cross_modal_decoder_heads=8,
        cross_modal_decoder_layers=2)
    if s.debug:
        swinv2 = swinv2.override(image_embedding_size=16, encoder_hidden_size=16,
                                 encoder_layers=2, encoder_d_ff=32)
    c["ROUTEFORMER_CONFIG_SWINV2"] = swinv2
    gaze = c["ROUTEFORMER_CONFIG_SWINV2_GAZE"] = swinv2.override(with_gaze=True)
    c["ROUTEFORMER_CONFIG_SWINV2_GAZE_AUTOREG"] = gaze.override(
        autoregressive=True, autoregressive_step_size=int(4 * s.output_fps))
    c["ROUTEFORMER_CONFIG_SWINV2_GAZE_WOUT_SCENE"] = gaze.override(
        with_scene=False, gaze_dropout=0.0)
    c["GIMO_CONFIG_SWINV2"] = gaze.override(dense_prediction=False)
    c["MULTIMODAL_TRANSFORMER_CONFIG_SWINV2"] = c["GIMO_CONFIG_SWINV2"]
    return c


# The JAX driver's models, in its order: name -> (model sets, seed (its
# ``rngs(i)``), class, config, GPS backbone and, where it replaces the
# config's, its GPS backbone config). Classes and backbones are named here
# and resolved when ``build_models`` imports them.
MODELS = {
    FLAGSHIP: (("full", "flagship"), 0, "Routeformer", "ROUTEFORMER_CONFIG_SWINV2_GAZE",
               "Informer", None),
    FLAGSHIP + "_autoreg_4s": (("full",), 1, "Routeformer",
                               "ROUTEFORMER_CONFIG_SWINV2_GAZE_AUTOREG", "Informer", None),
    FLAGSHIP + "_wout_scene": (("full",), 2, "Routeformer",
                               "ROUTEFORMER_CONFIG_SWINV2_GAZE_WOUT_SCENE", "Informer", None),
    "AdaptedGIMO_swinv2": (("full",), 3, "AdaptedGIMO", "GIMO_CONFIG_SWINV2", None, None),
    "MultiModalTransformer_swinv2": (("full",), 4, "MultiModalTransformer",
                                     "MULTIMODAL_TRANSFORMER_CONFIG_SWINV2", None, None),
    "Routeformer_with_video_swinv2": (("full",), 5, "Routeformer",
                                      "ROUTEFORMER_CONFIG_SWINV2", "Informer", None),
    "AutoBotEgo": (("full", "gps"), 6, "AutoBotAdapted", "ROUTEFORMER_CONFIG", None, None),
    "Routeformer_without_video_informer": (("full", "gps"), 7, "Routeformer",
                                           "ROUTEFORMER_CONFIG", "Informer", None),
    "Routeformer_without_video_transformer": (("full", "gps"), 8, "Routeformer",
                                              "ROUTEFORMER_CONFIG", "Transformer", None),
    "Routeformer_without_video_dlinear": (("full", "gps"), 9, "Routeformer",
                                          "ROUTEFORMER_CONFIG", "DLinear",
                                          "LINEAR_BACKBONE_CONFIG"),
    "Routeformer_without_video_nlinear": (("full", "gps"), 10, "Routeformer",
                                          "ROUTEFORMER_CONFIG", "NLinear",
                                          "LINEAR_BACKBONE_CONFIG"),
    "stationary_baseline": (("full", "gps"), 11, "Routeformer", "ROUTEFORMER_CONFIG",
                            "StationaryBaseline", None),
    "linear_baseline": (("full", "gps"), 12, "Routeformer", "ROUTEFORMER_CONFIG",
                        "LinearBaseline", None),
}


def model_names(model_set: str) -> list:
    """The names ``build_models`` gives for a model set, in order."""
    if model_set not in ("full", "gps", "flagship"):
        raise ValueError(f"MODEL_SET={model_set!r}: expected full, gps or flagship")
    return [name for name, (sets, *_) in MODELS.items() if model_set in sets]


def build_models(s: Settings) -> dict:
    """The candidate models of ``MODEL_SET``, with the JAX driver's names,
    classes and configs; model ``i`` of the JAX driver's list takes
    ``init_weights(model, seed=i)`` where the JAX driver takes ``rngs(i)``.
    ``USE_PATCHTST_BACKBONE=1`` puts PatchTST under the flagship."""
    from routeformer_torch import baselines
    from routeformer_torch.flagship import init_weights
    from routeformer_torch.models import Routeformer, gps_backbone

    c = driver_configs(s)
    models = {}
    for name in model_names(s.model_set):
        _, seed, cls, config, gps, gps_config = MODELS[name]
        if name == FLAGSHIP and s.use_patchtst_backbone:
            gps, gps_config = "PatchTST", "PATCHTST_BACKBONE_CONFIG"
        config = c[config]
        if gps_config is not None:
            config = config.override(gps_backbone_config=c[gps_config])
        if cls == "Routeformer":
            model = Routeformer(config, gps_backbone=getattr(gps_backbone, gps))
        else:
            model = getattr(baselines, cls)(config)
        init_weights(model, seed=seed)
        models[name] = model
    return models


def build_data(s: Settings, with_video: Optional[bool] = None, device=None,
               host_arrays: bool = False, mesh=None):
    """``(train, val)``: ``DataLoader``s over a GEM or DR(eye)VE recording
    when its ``*_DATASET_DIR`` is a directory, else synthetic datasets of
    pre-collated batches. The loaders place batches on ``device`` from
    their producer thread (with the frame store when ``H2D_DEDUP=1``)
    unless ``host_arrays`` (the embedding cache's precompute takes host
    pixels); on a ``mesh`` each rank's loaders read its rows only."""
    with_video = s.with_video if with_video is None else with_video
    if s.recording:
        from routeformer_torch.io.loader import DataLoader

        common = dict(
            input_length=INPUT_LENGTH_SECONDS, target_length=TARGET_LENGTH_SECONDS,
            step_size=STEP_SIZE_SECONDS, output_fps=s.output_fps,
            gopro_scaling_factor=s.gopro_scaling_factor,
            front_scaling_factor=s.front_scaling_factor, with_video=with_video,
            use_cache=s.dataset_cache_dir is not None, cache_dir=s.dataset_cache_dir,
            video_dtype=s.video_dtype, use_memory_cache=s.use_memory_cache,
            max_memory_cache_size=s.max_memory_cache_size)
        if s.dataset == "DREYEVE":
            from routeformer_torch.io.dataset_dreyeve import DreyeveDataset

            ds_train = DreyeveDataset(
                root_dir=s.dataset_dir, split="train", min_pci=0,
                enable_pci_split=s.enable_pci_split,
                pci_split_n_samples_per_bin=s.pci_split_n_samples_per_bin, **common)
            ds_val = DreyeveDataset(root_dir=s.dataset_dir, split="val", min_pci=s.min_pci,
                                    **common)
        else:
            from routeformer_torch.io.dataset import GEMDataset

            ds_train = GEMDataset(root=s.dataset_dir, split="train", min_pci=0,
                                  with_gaze=with_video, **common)
            ds_val = GEMDataset(root=s.dataset_dir, split="val", min_pci=s.min_pci,
                                with_gaze=with_video, **common)
        place = dict(to_device=not host_arrays, h2d_dedup=not host_arrays and s.h2d_dedup,
                     device=None if host_arrays else device, mesh=mesh)
        # the PCI split draws its own balanced sample, so it replaces shuffling
        return (DataLoader(ds_train, batch_size=s.batch_size, shuffle=not s.enable_pci_split,
                           **place),
                DataLoader(ds_val, batch_size=s.batch_size, shuffle=False, **place))
    from routeformer_torch.io.synthetic import SyntheticDataset

    common = dict(batch_size=s.batch_size, seq_len=s.seq_len, pred_len=s.pred_len,
                  fps=s.output_fps, with_video=with_video, with_gaze=with_video,
                  frame_hw=(24, 32) if s.debug else (54, 96))
    return (SyntheticDataset(n_batches=2 if s.debug else 64, seed=1, **common),
            SyntheticDataset(n_batches=1 if s.debug else 8, seed=2, **common))


def attach_prepare(s: Settings, data, prepare: Callable, device_memo: bool,
                   host_stage: bool = True) -> None:
    """Run ``prepare`` inside each loader's prefetch pipeline (the JAX
    driver's ``set_batch_stage``): as the host stage before placement (two
    pipelined producers when the device memo is active, else one;
    ``LOADER_PRODUCERS`` overrides), or, with ``host_stage=False``, on the
    placed batch."""
    from routeformer_torch.io.loader import DataLoader

    producers = s.loader_producers or (2 if device_memo else 1)
    for d in data:
        if not isinstance(d, DataLoader):
            continue
        if host_stage:
            d.set_batch_stage(prepare, producers=producers)
        else:
            d.set_placed_stage(prepare)


def iter_prepared(data, epoch: int, prepare: Callable, skip: int = 0, mesh=None):
    """An epoch's batches with ``prepare`` applied once: by the loader's
    stage for a ``DataLoader`` (``set_epoch`` reshuffles and resumes at
    ``skip``), here for a dataset of pre-collated batches (on a ``mesh``
    this rank's rows of them, as CPU tensors, as a mesh loader gives)."""
    if hasattr(data, "set_epoch"):
        data.set_epoch(epoch, start_batch=skip)
        yield from data
    else:
        for i in range(skip, len(data)):
            batch = data[i]
            if mesh is not None:
                import torch

                from routeformer_torch.parallel.mesh import shard_batch

                batch = shard_batch(batch, mesh, torch.device("cpu"))
            yield prepare(batch)


def build_precompute(s: Settings, models: dict, device, mesh=None):
    """The embedding cache's batch transform for ``USE_EMBEDDING_CACHE``
    (None when off, and for the ``gps`` and ``full`` sets, whose baselines
    take pixels): ``device`` the device memo (each rank's, on a ``mesh``),
    ``1``/``host`` the host RAM cache. Build it before the trainer lays
    the models out on a mesh."""
    if not s.embedding_cache_on:
        return None
    from routeformer_torch.models.video_backbone.cache import (
        DeviceVideoFeaturePrecomputer,
        MeshDeviceVideoFeaturePrecomputer,
        VideoFeaturePrecomputer,
    )

    model = models[FLAGSHIP]
    if s.use_embedding_cache == "device":
        if mesh is not None:
            return MeshDeviceVideoFeaturePrecomputer(model, mesh, device=device)
        return DeviceVideoFeaturePrecomputer(model, device=device)
    return VideoFeaturePrecomputer(model, device=device)


def build_trainer(s: Settings, models: dict, device, mesh=None):
    """The lockstep trainer with the JAX driver's optimizer (AdamW at
    ``ROUTEFORMER_CONFIG``'s ``lr`` and ``wd``, backbone 1e-6, warmup 2
    epochs, clip 2.5) and its losses from ``ROUTEFORMER_CONFIG``; an
    embedding cache keeps the backbone frozen for the whole run. On a
    ``mesh`` the models are laid out by the structural rule (``FSDP=1``
    also over ``data``)."""
    from routeformer_torch.optimizers import build_optimizer
    from routeformer_torch.train.trainer import ParallelTrainer

    cache_on = s.embedding_cache_on
    config = driver_configs(s)["ROUTEFORMER_CONFIG"]
    return ParallelTrainer(
        models,
        functools.partial(build_optimizer, learning_rate=config.lr, weight_decay=config.wd,
                          video_backbone_lr=1e-6, warmup_epochs=2, max_epochs=s.epochs,
                          gradient_clip_val=2.5),
        config, quartiles=s.quartiles,
        feature_cache_active=cache_on,
        unfreeze_epoch=None if cache_on else 10, device=device, mesh=mesh, fsdp=s.fsdp,
    )


def make_prepare(precompute: Optional[Callable], split_video: bool = False) -> Callable:
    """The batch stage: DR(eye)VE's left-video split, then the embedding
    cache's precompute (either may be off)."""
    from routeformer_torch.train.trainer import maybe_split_video

    def prepare(batch: dict) -> dict:
        batch = maybe_split_video(batch, split_video)
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
    end when snapshots are on. Returns one record per epoch. On a mesh
    every rank runs it; only rank 0 prints."""
    from routeformer_torch.parallel.mesh import is_main_rank

    history = []
    names = trainer.model_names
    mesh = trainer.mesh
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        trainer.epoch = epoch
        skip = start_batch if epoch == start_epoch else 0
        n_train = len(train_data)
        for j, batch in enumerate(iter_prepared(train_data, epoch, prepare, skip, mesh)):
            i = skip + j
            if max_train_batches is not None and i >= max_train_batches:
                break
            metrics = trainer.training_step(batch)
            if i % 10 == 0:
                metrics_logger.log(metrics, epoch * n_train + i, "train")
            if save_every and (i + 1) % save_every == 0:
                ckpt.save_latest(trainer, epoch, next_batch=i + 1)
        val_metrics = trainer.evaluate(iter_prepared(val_data, epoch, prepare, mesh=mesh),
                                       "val")
        metrics_logger.log(val_metrics, epoch, "val")
        ckpt.maybe_save(trainer, val_metrics, epoch)
        if save_every:
            ckpt.save_latest(trainer, epoch + 1, next_batch=0)
        history.append({"epoch": epoch, "seconds": time.perf_counter() - t0,
                        "val": val_metrics})
        if is_main_rank():
            print(f"epoch {epoch}: " + ", ".join(
                f"{n}={float(val_metrics.get(f'val_{n}_ade', np.nan)):.3f}"
                for n in names[:3]), flush=True)
    return history


class _NoLogger:
    """The metrics stream of a rank other than 0."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def spawn_ranks(n: int, env=None) -> int:
    """One rank per visible card, each this driver in its own process
    (``torchrun``'s environment: ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); returns the first nonzero exit code,
    else 0. A rank that fails stops the others."""
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    base = dict(os.environ, **(env or {}), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                WORLD_SIZE=str(n))
    procs = [subprocess.Popen([sys.executable, "-m", "routeformer_torch.experiments."
                               "full_comparison"],
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = next((c for c in codes if c not in (None, 0)), None)
            if bad is not None or all(c == 0 for c in codes):
                return bad or 0
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def main(env=None) -> list:
    """Train as the environment says; returns ``run_epochs``' records."""
    from routeformer_torch.train.checkpoints import CheckpointManager
    from routeformer_torch.train.logging import MetricsLogger
    from routeformer_torch.utils.device import resolve_device
    from routeformer_torch.utils.logging import set_logger_config

    import torch

    from routeformer_torch.parallel import mesh as meshlib

    s = Settings.from_env(env)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if ("WORLD_SIZE" not in os.environ and not s.force_cpu and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        code = spawn_ranks(torch.cuda.device_count(), env)
        if code:
            raise SystemExit(code)
        return []
    set_logger_config("DEBUG" if s.debug else "ERROR")
    mesh = None
    if world > 1:
        device = meshlib.init_distributed("cpu" if s.force_cpu else None)
        mesh = meshlib.make_mesh(*mesh_shape(s, world), device=device)
        if meshlib.is_main_rank():
            print(f"mesh: data={mesh.size(0)} model={mesh.size(1)}")
    else:
        device = resolve_device("cpu" if s.force_cpu else None)
    main_rank = meshlib.is_main_rank()
    models = build_models(s)
    config = driver_configs(s)["ROUTEFORMER_CONFIG"]
    if s.embedding_cache_on and main_rank:
        print("USE_EMBEDDING_CACHE active: video backbones stay frozen for the "
              "entire run (epoch-10 unfreeze disabled)")
    precompute = build_precompute(s, models, device, mesh)
    trainer = build_trainer(s, models, device, mesh)
    ckpt = CheckpointManager(s.results_dir / "checkpoints")
    metrics_logger = (MetricsLogger(s.results_dir / "logs",
                                    experiment=f"{s.dataset.lower()}_full_comparison",
                                    config=config.to_dict()) if main_rank else _NoLogger())
    train_data, val_data = build_data(s, device=device, host_arrays=precompute is not None,
                                      mesh=mesh)
    prepare = make_prepare(precompute, split_video=s.split_video)
    if precompute is not None:
        attach_prepare(s, (train_data, val_data), prepare,
                       device_memo=s.use_embedding_cache == "device")
    elif s.split_video:  # the halves as views of the placed tensor
        attach_prepare(s, (train_data, val_data), prepare, device_memo=False,
                       host_stage=False)
    # else prepare is the identity: the loaders collate into pinned memory
    start_epoch, start_batch = 0, 0
    if s.resume:
        latest = ckpt.restore_latest(trainer)
        if latest is not None:
            start_epoch, start_batch = latest
            msg = f"resumed latest snapshot: epoch {start_epoch} batch {start_batch}"
        else:
            start_epoch = ckpt.restore_all(trainer)
            msg = f"resumed from best checkpoints at epoch {start_epoch}"
        if main_rank:
            print(msg)
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
    if main_rank:
        print("best:", ckpt.best)
    if mesh is not None:
        meshlib.barrier()
        torch.distributed.destroy_process_group()
    return history


if __name__ == "__main__":
    main()
