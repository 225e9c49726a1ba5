"""The port's checkpoints on the CPU: best-only saving and ``restore_all``'s
epoch; the latest snapshot's exact resume (mid-epoch, with dropout, motion
noise, view and gaze dropout and ProbSparse train draws all on: the two
steps after a restore give the same bits as the uninterrupted run); the
recovery of an interrupted swap; no snapshot gives None."""

import os

import numpy as np
import pytest
import torch

from routeformer_torch.train.checkpoints import CheckpointManager
from test_torch_trainer import (  # noqa: F401  (one_torch_thread: autouse)
    TRAIN,
    VAL,
    one_torch_thread,
    port_models,
    port_trainer,
)


def _noisy_trainer(seed):
    """The small Routeformer with every stochastic part of training on."""
    torch.manual_seed(seed)
    models = port_models(factor=5, feature_dropout=0.1, view_dropout=0.5,
                         gaze_dropout=0.3, motion_noise=0.05)
    return port_trainer(models)


def _params(trainer):
    return {k: p.detach().clone() for k, p in trainer.models.named_parameters()}


def test_best_only_saving_and_restore_all(tmp_path):
    trainer = port_trainer(port_models())
    ckpt = CheckpointManager(tmp_path)
    key = "val_routeformer_ade"
    assert ckpt.maybe_save(trainer, {key: 5.0}, epoch=0) == {"routeformer": True}
    assert ckpt.maybe_save(trainer, {key: 6.0}, epoch=1) == {"routeformer": False}
    saved = _params(trainer)
    assert ckpt.maybe_save(trainer, {key: 4.0, "val_stationary_baseline_ade": 9.0},
                           epoch=2) == {"routeformer": True, "stationary_baseline": True}
    assert ckpt.best["routeformer"] == {"value": 4.0, "epoch": 2, "metric": key}

    other = port_trainer(port_models())  # other weights: the test models' init is random
    again = CheckpointManager(tmp_path)  # reads the index back
    assert again.best == ckpt.best
    assert again.restore_all(other) == 3
    for k, v in _params(other).items():
        assert torch.equal(v, saved[k]), k
    assert CheckpointManager(tmp_path / "empty").restore_all(other) == 0


def test_latest_resume_is_bit_exact(tmp_path):
    """Uninterrupted: step, snapshot after batch 0, two more steps.
    Resumed: a fresh trainer with other weights restores the snapshot and
    takes the same two steps: the same losses and parameters, bit for bit."""
    batches = [TRAIN[0], TRAIN[1], TRAIN[0]]
    run = _noisy_trainer(0)
    run.epoch = 4
    ckpt = CheckpointManager(tmp_path)
    run.training_step(batches[0])
    ckpt.save_latest(run, epoch=4, next_batch=1)
    want = [run.training_step(b)["train_total_loss"] for b in batches[1:]]
    want_p = _params(run)

    resumed = _noisy_trainer(1)
    torch.rand(7)  # a different generator state than at the snapshot
    assert CheckpointManager(tmp_path).restore_latest(resumed) == (4, 1)
    resumed.epoch = 4
    assert resumed.optimizer.count == 1
    got = [resumed.training_step(b)["train_total_loss"] for b in batches[1:]]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for k, v in _params(resumed).items():
        assert torch.equal(v, want_p[k]), k
    # and MC eval after the resume equals the uninterrupted run's
    for k, v in resumed.evaluate(VAL[:1]).items():
        assert torch.equal(v, run.evaluate(VAL[:1])[k]), k


@pytest.mark.parametrize("left", ["_latest.tmp", "_latest.old"])
def test_interrupted_swap_is_promoted(tmp_path, left):
    """A crash inside the two-rename swap leaves the complete snapshot under
    ``_latest.tmp`` (before the second rename) or ``_latest.old`` (between
    the renames of a first save); both the next restore and the next save
    promote it."""
    trainer = port_trainer(port_models())
    ckpt = CheckpointManager(tmp_path)
    ckpt.save_latest(trainer, epoch=2, next_batch=5)
    os.rename(tmp_path / "_latest", tmp_path / left)
    assert ckpt.restore_latest(trainer) == (2, 5)
    assert (tmp_path / "_latest").exists() and not (tmp_path / left).exists()

    os.rename(tmp_path / "_latest", tmp_path / left)
    ckpt.save_latest(trainer, epoch=3, next_batch=0)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["_latest"]
    assert ckpt.restore_latest(trainer) == (3, 0)


def test_no_snapshot_gives_none(tmp_path):
    trainer = port_trainer(port_models())
    ckpt = CheckpointManager(tmp_path)
    assert ckpt.restore_latest(trainer) is None
    (tmp_path / "_latest").mkdir()  # a snapshot cut before its position file
    torch.save({}, tmp_path / "_latest" / "ckpt.pt")
    assert ckpt.restore_latest(trainer) is None


def test_snapshot_of_another_model_set_gives_none(tmp_path):
    trainer = port_trainer(port_models())
    CheckpointManager(tmp_path).save_latest(trainer, epoch=1)
    other = port_trainer({"routeformer": port_models()["stationary_baseline"]})
    assert CheckpointManager(tmp_path).restore_latest(other) is None
    assert np.isfinite(float(trainer.training_step(TRAIN[0])["train_total_loss"]))
