"""The port's training driver (``python -m
routeformer_torch.experiments.full_comparison``) on the CPU at the DEBUG
widths: the epoch lines and ``best:``, resume, the device feature memo,
the refusals of what is not ported, and no CUDA without
``ROUTEFORMER_FORCE_CPU``."""

import json

import pytest
import torch

from routeformer_torch.experiments import full_comparison as fc
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

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


@pytest.mark.parametrize("extra,match", [
    ({"MODEL_SET": "gps"}, "ROADMAP.md §1 item 7"),
    ({"MODEL_SET": "full"}, "ROADMAP.md §1 item 7"),
    ({"USE_PATCHTST_BACKBONE": "1"}, "ROADMAP.md §1 item 7"),
    ({"FSDP": "1"}, "ROADMAP.md §1 item 6"),
])
def test_driver_refuses_what_is_not_ported(tmp_path, extra, match):
    with pytest.raises(NotImplementedError, match=match):
        fc.main(dict(BASE, RESULTS_DIR=str(tmp_path), **extra))


def test_driver_refuses_a_dataset_directory(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 4"):
        fc.main(dict(BASE, RESULTS_DIR=str(tmp_path / "r"),
                     ROUTEFORMER_DATASET_DIR=str(tmp_path)))


def test_driver_needs_cuda_without_force_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    env = {k: v for k, v in BASE.items() if k != "ROUTEFORMER_FORCE_CPU"}
    with pytest.raises(RuntimeError, match="CUDA"):
        fc.main(dict(env, RESULTS_DIR=str(tmp_path)))
