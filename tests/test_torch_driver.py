"""The port's training driver (``python -m
routeformer_torch.experiments.full_comparison``) on the CPU at the DEBUG
widths: the epoch lines and ``best:``, resume, the device feature memo,
the ``gps`` and ``full`` model sets and PatchTST under the flagship, the
refusals of what is not ported, and no CUDA without
``ROUTEFORMER_FORCE_CPU``; and against the JAX driver
(``experiments/full_comparison.py``, loaded through ``importlib`` with the
environment set): every config field for field, and the driver-built
flagship's eval forward."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_torch.convert import load_flax_params
from routeformer_torch.experiments import full_comparison as fc
from routeformer_torch.io.synthetic import synthetic_batch_numpy
from routeformer_torch.models import Routeformer
from test_torch_models import export_params
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

JAX_DRIVER = Path(__file__).resolve().parents[1] / "experiments" / "full_comparison.py"
# TimmBackboneConfig knobs of the JAX package that the port does not carry:
# the TPU's frame minibatching, its persistent disk cache, checkpoint
# import and the Pallas window-kernel switch.
JAX_ONLY_FIELDS = {"backbone_minibatch_size", "max_persistent_cache_size", "checkpoint_path",
                   "window_flash"}

BASE = {"ROUTEFORMER_FORCE_CPU": "1", "DEBUG": "1", "EPOCHS": "2", "BATCH_SIZE": "2",
        "MODEL_SET": "flagship", "DATASET": "GEM"}


def _run(capsys, tmp_path, **extra):
    env = dict(BASE, RESULTS_DIR=str(tmp_path), **extra)
    history = fc.main(env)
    return history, capsys.readouterr().out.splitlines()


def test_driver_trains_checkpoints_and_resumes(capsys, tmp_path):
    history, lines = _run(capsys, tmp_path, SAVE_EVERY_STEPS="1")
    epochs = [line for line in lines if line.startswith("epoch ")]
    assert [line.split(":")[0] for line in epochs] == ["epoch 0", "epoch 1"]
    assert lines[-1].startswith("best: {") and fc.FLAGSHIP in lines[-1]
    assert [h["epoch"] for h in history] == [0, 1]
    assert (tmp_path / "checkpoints" / "_latest" / "position.json").exists()
    assert json.loads((tmp_path / "checkpoints" / "_latest" / "position.json")
                      .read_text()) == {"epoch": 2, "next_batch": 0}
    metrics = (tmp_path / "logs" / "gem_full_comparison.metrics.jsonl").read_text()
    assert metrics.count('"split": "val"') == 2

    history, lines = _run(capsys, tmp_path, EPOCHS="3", RESUME="1")
    assert "resumed latest snapshot: epoch 2 batch 0" in lines
    assert [line.split(":")[0] for line in lines if line.startswith("epoch ")] == ["epoch 2"]
    assert [h["epoch"] for h in history] == [2]


def test_driver_resumes_from_best_checkpoints(capsys, tmp_path):
    _run(capsys, tmp_path, EPOCHS="1")
    history, lines = _run(capsys, tmp_path, RESUME="1")
    assert "resumed from best checkpoints at epoch 1" in lines
    assert [h["epoch"] for h in history] == [1]


def test_driver_with_the_device_memo(capsys, tmp_path):
    history, lines = _run(capsys, tmp_path, EPOCHS="1", USE_EMBEDDING_CACHE="device")
    assert lines[0].startswith("USE_EMBEDDING_CACHE active")
    assert len(history) == 1 and lines[-1].startswith("best:")


@pytest.mark.parametrize("extra,n_models", [
    ({"MODEL_SET": "gps"}, 7),
    ({"MODEL_SET": "full"}, 13),
    ({"USE_PATCHTST_BACKBONE": "1"}, 1),
], ids=["gps", "full", "patchtst"])
def test_driver_trains_the_model_sets_and_resumes(capsys, tmp_path, extra, n_models):
    """Two epochs with a snapshot every step, a ``best:`` line naming every
    model of the set (the JAX driver's names), then a resume."""
    history, lines = _run(capsys, tmp_path, SAVE_EVERY_STEPS="1", **extra)
    names = fc.model_names(extra.get("MODEL_SET", "flagship"))
    assert len(names) == n_models
    assert [line.split(":")[0] for line in lines if line.startswith("epoch ")] == [
        "epoch 0", "epoch 1"]
    best = lines[-1]
    assert best.startswith("best: {") and all(f"'{n}'" in best for n in names)
    for record in history:
        assert all(np.isfinite(record["val"][f"val_{n}_ade"].item()) for n in names)
    history, lines = _run(capsys, tmp_path, EPOCHS="3", RESUME="1", **extra)
    assert "resumed latest snapshot: epoch 2 batch 0" in lines
    assert [h["epoch"] for h in history] == [2]


def test_driver_builds_the_jax_drivers_models():
    """Names, classes, backbones and seeds of the three sets; PatchTST under
    the flagship with ``USE_PATCHTST_BACKBONE``; the driver's SwinV2 blocks
    take the exact gelu (the unfused block)."""
    s = fc.Settings.from_env(dict(BASE, MODEL_SET="full"))
    models = fc.build_models(s)
    assert list(models) == fc.model_names("full") == list(fc.MODELS)
    assert fc.model_names("gps") == fc.model_names("full")[6:]
    assert fc.model_names("flagship") == [fc.FLAGSHIP]
    kinds = {n: (type(m).__name__, type(getattr(m, "gps_backbone", None)).__name__)
             for n, m in models.items()}
    assert kinds["AdaptedGIMO_swinv2"][0] == "AdaptedGIMO"
    assert kinds["MultiModalTransformer_swinv2"][0] == "MultiModalTransformer"
    assert kinds["AutoBotEgo"][0] == "AutoBotAdapted"
    assert kinds["Routeformer_without_video_transformer"][1] == "Transformer"
    assert kinds["Routeformer_without_video_dlinear"][1] == "DLinear"
    assert kinds["Routeformer_without_video_nlinear"][1] == "NLinear"
    assert kinds["stationary_baseline"][1] == "StationaryBaseline"
    assert models[fc.FLAGSHIP + "_autoreg_4s"].configs.autoregressive_step_size == 20
    for m in models.values():
        backbone = getattr(m, "video_backbone", None)
        if backbone is not None:
            blocks = [b for b in backbone.modules() if type(b).__name__ == "SwinBlock"]
            assert blocks and not any(b.gelu_approximate for b in blocks)
    patch = fc.build_models(fc.Settings.from_env(dict(BASE, USE_PATCHTST_BACKBONE="1")))
    assert type(patch[fc.FLAGSHIP].gps_backbone).__name__ == "PatchTST"


# The gps and full sets and PatchTST, refused before the zoo was ported,
# now train (above), and so does FSDP=1 (one process: no mesh, as the JAX
# driver has none on one device); what the driver refuses is the JAX
# driver's mesh refusal, a BATCH_SIZE the data shards do not divide.
@pytest.mark.parametrize("extra,match", [({"FSDP": "1"}, "must be divisible")],
                         ids=["extra3-ROADMAP.md §1 item 6"])
def test_driver_refuses_what_is_not_ported(tmp_path, extra, match):
    history = fc.main(dict(BASE, RESULTS_DIR=str(tmp_path), **extra))
    assert len(history) == int(BASE.get("EPOCHS", 1))
    s = fc.Settings.from_env(dict(BASE, BATCH_SIZE="6", N_MODEL_SHARDS="2", **extra))
    assert s.fsdp and s.n_model_shards == 2
    assert fc.mesh_shape(s, world=6) == (3, 2)
    with pytest.raises(SystemExit, match=match) as e:
        fc.mesh_shape(s, world=8)
    assert str(e.value) == ("BATCH_SIZE=6 must be divisible by the data-parallel degree 4 "
                            "(devices=8, N_MODEL_SHARDS=2)")


def test_driver_trains_on_two_gloo_ranks(tmp_path):
    """``torchrun --nproc_per_node=2`` of the driver on the CPU: a
    ``(2, 1)`` mesh over gloo with FSDP, two epochs; rank 0 alone prints
    (the mesh line, one line per epoch, ``best:``) and writes the metrics
    stream and checkpoints."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, **dict(BASE, BATCH_SIZE="4", FSDP="1", RESULTS_DIR=str(tmp_path),
                                  SAVE_EVERY_STEPS="1", OMP_NUM_THREADS="1"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         f"--master_port={port}", "-m", "routeformer_torch.experiments.full_comparison"],
        cwd=Path(fc.__file__).resolve().parents[2], env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert lines[0] == "mesh: data=2 model=1", lines
    assert [ln.split(":")[0] for ln in lines[1:]] == ["epoch 0", "epoch 1", "best"], lines
    records = (tmp_path / "logs" / "gem_full_comparison.metrics.jsonl").read_text().splitlines()
    assert sum('"split": "val"' in r for r in records) == 2
    assert (tmp_path / "checkpoints" / "_latest" / "position.json").exists()


@pytest.fixture(scope="module")
def dreyeve_dir(tmp_path_factory):
    """The port's DR(eye)VE sessions: 01 (train) and 45 (val), 20 s at
    (36, 64), only the windows' frames."""
    from routeformer_torch.io.dreyeve_fixture import build_dreyeve_fixture

    return build_dreyeve_fixture(tmp_path_factory.mktemp("dreyeve"), session_ids=(1, 45),
                                 duration_s=20.0, sparse=True)


DREYEVE = dict(BASE, DATASET="DREYEVE", MIN_PCI="0")


def test_driver_refuses_a_dataset_directory(capsys, tmp_path, dreyeve_dir):
    """Refused before the DR(eye)VE reader was ported, a DR(eye)VE directory
    now trains to the ``best:`` line; audio, refused before ``io/audio.py``
    was ported, is taken: a GEM dataset with audio reads the directory and
    finds no GEM window in it."""
    from routeformer_torch.io.dataset import GEMDataset

    env = dict(DREYEVE, EPOCHS="1", RESULTS_DIR=str(tmp_path / "r"),
               DREYEVE_DATASET_DIR=str(dreyeve_dir))
    history = fc.main(env)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("best: {") and fc.FLAGSHIP in lines[-1]
    assert np.isfinite(float(history[0]["val"][f"val_{fc.FLAGSHIP}_ade"]))
    assert len(GEMDataset(root=tmp_path, with_audio=True)) == 0


def test_driver_splits_the_dreyeve_view_once(dreyeve_dir):
    """``DATASET=DREYEVE`` with a directory: ``DreyeveDataset`` splits
    (train at ``min_pci=0``, val at ``MIN_PCI``) behind placing loaders;
    the left-video split runs once, on the placed batch, as views of one
    tensor; ``ENABLE_LEFT_VIDEO_SPLIT=0`` keeps the single view; the PCI
    split turns the train loader's shuffle off."""
    from routeformer_torch.io.dataset_dreyeve import DreyeveDataset

    s = fc.Settings.from_env(dict(DREYEVE, DREYEVE_DATASET_DIR=str(dreyeve_dir)))
    assert s.split_video and not s.enable_pci_split
    train, val = fc.build_data(s, device=torch.device("cpu"))
    assert isinstance(train.dataset, DreyeveDataset) and train.dataset.min_pci == 0
    assert val.dataset.split == list(range(45, 60)) and train.shuffle and not val.shuffle
    prepare = fc.make_prepare(None, split_video=True)
    fc.attach_prepare(s, (train, val), prepare, device_memo=False, host_stage=False)
    assert train.placed_transform is prepare and train.batch_transform is None
    train.set_epoch(0)
    batch = next(iter(train))
    width = train.dataset[0]["train"]["left_video"].shape[2]
    for phase in ("train", "target"):
        left, right = batch[phase]["left_video"], batch[phase]["right_video"]
        assert (left.shape[3], right.shape[3]) == (width // 2, width - width // 2)
        assert left.untyped_storage().data_ptr() == right.untyped_storage().data_ptr()
        assert prepare(batch)[phase]["left_video"] is left  # a second split changes nothing

    off = fc.Settings.from_env(dict(DREYEVE, DREYEVE_DATASET_DIR=str(dreyeve_dir),
                                    ENABLE_LEFT_VIDEO_SPLIT="0"))
    assert not off.split_video
    pci = fc.Settings.from_env(dict(DREYEVE, DREYEVE_DATASET_DIR=str(dreyeve_dir),
                                    ENABLE_PCI_SPLIT="1", PCI_SPLIT_N_SAMPLES_PER_BIN="3"))
    train, _ = fc.build_data(pci, device=torch.device("cpu"))
    assert not train.shuffle and train.dataset.enable_pci_split
    assert train.dataset.bin_epoch_size == 3 * len(train.dataset.data_bins)
    gem = fc.Settings.from_env(dict(BASE, ENABLE_PCI_SPLIT="1"))
    assert not gem.enable_pci_split and not gem.split_video


@pytest.fixture(scope="module")
def gem_dir(tmp_path_factory):
    """The port's raw recording: subject 001 (train) and 002 (val), 20 s,
    weaving enough for the val windows to pass MIN_PCI=20."""
    from routeformer_torch.io.gem_fixture import build_gem_fixture

    root = tmp_path_factory.mktemp("gem")
    build_gem_fixture(root, duration_s=20.0, subject="001", seed=0, turn=1.0)
    build_gem_fixture(root, duration_s=20.0, subject="002", seed=10, turn=1.0)
    return root


def test_driver_trains_on_a_gem_recording(capsys, tmp_path, gem_dir):
    """``ROUTEFORMER_DATASET_DIR`` points at a recording: the driver builds
    the GEM splits behind placing loaders (frame store on), trains and
    evaluates to its ``best:`` line; the loaders hold the index the
    dataset predicts."""
    s = fc.Settings.from_env(dict(BASE, ROUTEFORMER_DATASET_DIR=str(gem_dir)))
    train, val = fc.build_data(s, device=torch.device("cpu"))
    assert (len(train.dataset), len(train)) == (3, 1) and len(val.dataset) >= 2
    assert train.to_device and train.h2d_dedup and train.shuffle and not val.shuffle
    history, lines = _run(capsys, tmp_path, EPOCHS="1", ROUTEFORMER_DATASET_DIR=str(gem_dir))
    assert [line.split(":")[0] for line in lines if line.startswith("epoch ")] == ["epoch 0"]
    assert lines[-1].startswith("best: {") and fc.FLAGSHIP in lines[-1]
    assert np.isfinite(float(history[0]["val"][f"val_{fc.FLAGSHIP}_ade"]))


def test_driver_needs_cuda_without_force_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = {k: v for k, v in BASE.items() if k != "ROUTEFORMER_FORCE_CPU"}
    with pytest.raises(RuntimeError, match="CUDA"):
        fc.main(dict(env, RESULTS_DIR=str(tmp_path)))


def _jax_driver(monkeypatch, env: dict):
    """The JAX driver module, executed afresh with ``env`` set."""
    for key in ("DEBUG", "DATASET", "MODEL_SET", "USE_PATCHTST_BACKBONE", "COMPUTE_DTYPE",
                "ROUTEFORMER_FORCE_CPU", "EPOCHS", "BATCH_SIZE"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    spec = importlib.util.spec_from_file_location("jax_full_comparison", JAX_DRIVER)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _assert_same_config(port, want, path):
    assert type(port).__name__ == type(want).__name__, path
    port_fields = {f.name for f in dataclasses.fields(port)}
    want_fields = {f.name for f in dataclasses.fields(want)}
    assert port_fields - want_fields == set(), path
    assert want_fields - port_fields <= JAX_ONLY_FIELDS, (path, want_fields - port_fields)
    for name in sorted(port_fields):
        a, b = getattr(port, name), getattr(want, name)
        if dataclasses.is_dataclass(b):
            _assert_same_config(a, b, f"{path}.{name}")
        else:
            assert a == b, (f"{path}.{name}", a, b)
    for prop in ("enc_in", "c_out", "dec_in", "patch_len", "stride"):
        if hasattr(want, prop):
            assert getattr(port, prop) == getattr(want, prop), (path, prop)


@pytest.mark.parametrize("dataset", ["DREYEVE", "GEM"])
@pytest.mark.parametrize("debug", ["0", "1"], ids=["full-width", "debug"])
def test_driver_configs_match_the_jax_driver(monkeypatch, debug, dataset):
    env = {"DEBUG": debug, "DATASET": dataset}
    jax_driver = _jax_driver(monkeypatch, env)
    configs = fc.driver_configs(fc.Settings.from_env(env))
    assert len(configs) == 11
    for name, config in configs.items():
        _assert_same_config(config, getattr(jax_driver, name), name)
    assert configs["SWINV2_BACKBONE_CONFIG"].gelu == "exact"


def test_driver_flagship_matches_the_jax_drivers(monkeypatch, rng):
    """The flagship of ``MODEL_SET=flagship`` at the DEBUG widths, as each
    driver builds it, with the backbone computing in f32 on both sides
    (``COMPUTE_DTYPE=float32`` sets the rest): the same weights through
    ``load_flax_params``, one synthetic batch: the backbone's feature maps
    of one view and the eval forward at atol and rtol 1e-4. A tanh-gelu
    SwinV2 against the JAX driver's exact gelu parts the feature maps by
    2.2e-3 (of 3.4), and this test fails."""
    env = dict(BASE, COMPUTE_DTYPE="float32")
    jax_driver = _jax_driver(monkeypatch, env)
    # the JAX driver's flagship: its config and classes (_build_models)
    jax_cfg = jax_driver.ROUTEFORMER_CONFIG_SWINV2_GAZE
    jax_cfg = jax_cfg.override(
        video_backbone_config=jax_cfg.video_backbone_config.override(compute_dtype="float32"))
    jax_model = jax_driver.Routeformer(jax_cfg, gps_backbone=jax_driver.Informer,
                                       video_backbone=jax_driver.SwinV2,
                                       rngs=nnx.Rngs(0, dropout=1000))
    port_model = fc.build_models(fc.Settings.from_env(env))[fc.FLAGSHIP]
    cfg = port_model.configs.copy()
    cfg.video_backbone_config.compute_dtype = "float32"
    port = Routeformer(cfg, gps_backbone=type(port_model.gps_backbone),
                       video_backbone=type(port_model.video_backbone))
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.eval()
    port.eval()
    batch = synthetic_batch_numpy(3, 2, seq_len=40, pred_len=30, with_video=True,
                                  with_gaze=True, frame_hw=(24, 32))["train"]
    frames = batch["left_video"][:, -1]
    want = np.asarray(jax_model.video_backbone(jnp.asarray(frames)))
    with torch.no_grad():
        got = port.video_backbone(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    j_gps, j_dense = nnx.jit(lambda m, b: m(b))(
        jax_model, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        gps, dense = port({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(gps.numpy(), np.asarray(j_gps), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dense.numpy(), np.asarray(j_dense), atol=1e-4, rtol=1e-4)
