"""Checkpoints and exact resume (counterpart of
``routeformer_tpu/train/checkpoints.py``; ``torch.save`` in place of orbax).

- Best-only: each model's ``state_dict`` is saved when its monitored metric
  (``val_{name}_ade``) improves, with a JSON index of the best values.
  ``restore_all`` loads them and returns the epoch to resume from.
- Latest: ``save_latest`` writes a full snapshot for exact, mid-epoch
  resume: every model's ``state_dict``, the optimizer's state and update
  count, every generator state the train step reads (the CPU default
  generator, the CUDA ones when CUDA is in use, and the trainer's own) and
  the input position (``position.json``). The JAX package saves its rng key
  data for the same purpose. The write is crash-safe: a fresh temporary
  directory, the file synced, then two renames; a crash inside the swap
  leaves a complete snapshot under ``_latest.tmp`` or ``_latest.old``,
  which the next save or restore promotes.

Under a mesh (``trainer.mesh``) every rank calls ``maybe_save``,
``save_latest`` and ``restore_latest`` together: the models' and the
optimizer's state is gathered whole (``MeshParams.full_state_dict``;
the AdamW moments by their parameter's ``mesh_spec``) and only rank 0
writes, between barriers; a restore cuts the whole state to the blocks of
the trainer's own mesh, whatever mesh wrote it. Every rank's generator
states are saved, and a restore on a mesh of the same size gives each rank
its own back, so resume under the mesh is exact.
"""

import json
import os
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from routeformer_torch.parallel import mesh as meshlib
from routeformer_torch.utils.logging import get_logger

logger = get_logger("train.checkpoints")

CKPT_FILE = "ckpt.pt"
POSITION_FILE = "position.json"


def _save_synced(payload, path: Path) -> None:
    with open(path, "wb") as fh:
        torch.save(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())


def _load(path: Path):
    return torch.load(path, map_location="cpu", weights_only=True)


def generator_states(trainer) -> dict:
    """Every generator state a train step of ``trainer`` reads (this
    rank's; on a mesh, ``ranks`` holds every rank's)."""
    states = {"cpu": torch.get_rng_state(),
              "eval": trainer.eval_generator.get_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        states["cuda"] = torch.cuda.get_rng_state_all()
    if getattr(trainer, "shared_generator", None) is not None:
        states["shared"] = trainer.shared_generator.get_state()
    if getattr(trainer, "mesh", None) is not None:
        ranks = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(ranks, states)
        return {"ranks": ranks}
    return states


def set_generator_states(trainer, states: dict) -> None:
    if "ranks" in states:  # a mesh's snapshot: this rank's own, on a mesh of that size
        ranks = states["ranks"]
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
        if len(ranks) != (torch.distributed.get_world_size()
                          if torch.distributed.is_initialized() else 1):
            logger.warning("snapshot of %d ranks restored on another mesh: the generators "
                           "restart from rank 0's", len(ranks))
            rank = 0
        states = ranks[rank]
    torch.set_rng_state(states["cpu"])
    trainer.eval_generator.set_state(states["eval"])
    if "cuda" in states:
        torch.cuda.set_rng_state_all(states["cuda"])
    if "shared" in states and getattr(trainer, "shared_generator", None) is not None:
        trainer.shared_generator.set_state(states["shared"])


def model_state(trainer, name: str) -> dict:
    """A model's whole ``state_dict`` on the CPU (gathered on a mesh: every
    rank calls it)."""
    layout = getattr(trainer, "layouts", {}).get(name)
    if layout is not None:
        return layout.full_state_dict(trainer.models[name])
    return {k: v.detach().cpu() for k, v in trainer.models[name].state_dict().items()}


def load_model_state(trainer, name: str, state: dict) -> None:
    layout = getattr(trainer, "layouts", {}).get(name)
    if layout is not None:
        state = layout.block_state_dict(trainer.models[name], state)
    trainer.models[name].load_state_dict(state)


def optimizer_state(trainer) -> dict:
    """The optimizer's ``state_dict`` with the AdamW moments of sharded
    parameters gathered whole (every rank calls it on a mesh)."""
    opt = trainer.optimizer
    state = opt.opt.state_dict()
    if getattr(trainer, "mesh", None) is None:
        return state
    for i, p in enumerate(opt.params):
        spec = getattr(p, "mesh_spec", None)
        if spec is None or i not in state["state"]:
            continue
        state["state"][i] = {k: meshlib.spec_gather(v, spec, trainer.mesh).cpu()
                             if k != "step" else v for k, v in state["state"][i].items()}
    return state


def load_optimizer_state(trainer, state: dict) -> None:
    opt = trainer.optimizer
    if getattr(trainer, "mesh", None) is not None:
        state = {**state, "state": dict(state["state"])}
        for i, p in enumerate(opt.params):
            spec = getattr(p, "mesh_spec", None)
            if spec is not None and i in state["state"]:
                state["state"][i] = {
                    k: meshlib.spec_block(v, spec, trainer.mesh).clone() if k != "step" else v
                    for k, v in state["state"][i].items()}
    opt.opt.load_state_dict(state)


class CheckpointManager:
    """Best-metric checkpoints and the latest snapshot of a
    ``ParallelTrainer``'s models under ``directory``."""

    def __init__(self, directory, monitor: str = "val_{name}_ade", mode: str = "min"):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self._best: Dict[str, dict] = {}
        if self._index_path().exists():
            self._best = json.loads(self._index_path().read_text())

    def _index_path(self) -> Path:
        return self.directory / "index.json"

    def _is_better(self, value: float, best: float) -> bool:
        return value < best if self.mode == "min" else value > best

    def _model_path(self, name: str) -> Path:
        return self.directory / name / CKPT_FILE

    def maybe_save(self, trainer, val_metrics: Dict, epoch: int) -> Dict[str, bool]:
        """Save each model whose monitored metric improved; returns
        ``{model: saved?}``."""
        saved = {}
        worst = np.inf if self.mode == "min" else -np.inf
        for name in trainer.model_names:
            key = self.monitor.format(name=name)
            if key not in val_metrics:
                continue
            value = float(val_metrics[key])
            if not self._is_better(value, self._best.get(name, {}).get("value", worst)):
                saved[name] = False
                continue
            path = self._model_path(name)
            state = model_state(trainer, name)
            if meshlib.is_main_rank():
                path.parent.mkdir(parents=True, exist_ok=True)
                _save_synced(state, path)
            self._best[name] = {"value": value, "epoch": epoch, "metric": key}
            if meshlib.is_main_rank():
                self._index_path().write_text(json.dumps(self._best, indent=2))
            meshlib.barrier()
            saved[name] = True
            if meshlib.is_main_rank():
                logger.info("checkpointed %s at epoch %d (%s=%.4f)", name, epoch, key, value)
        return saved

    def restore(self, trainer, name: str) -> bool:
        """Load a model's best checkpoint into the trainer; False if none."""
        path = self._model_path(name)
        if not path.exists():
            return False
        load_model_state(trainer, name, _load(path))
        return True

    def restore_all(self, trainer) -> int:
        """Restore every model that has a checkpoint; returns the epoch to
        resume from (one past the newest restored, 0 if none)."""
        resume_epoch = 0
        for name in trainer.model_names:
            if self.restore(trainer, name):
                entry = self._best.get(name, {})
                resume_epoch = max(resume_epoch, int(entry.get("epoch", -1)) + 1)
                logger.info("restored %s (best %s)", name, entry)
        return resume_epoch

    # ------------------------------------------------------------ latest -- #

    def _latest_dir(self) -> Path:
        return (self.directory / "_latest").absolute()

    @staticmethod
    def _complete(path: Path) -> bool:
        """``position.json`` is written after the synced checkpoint file, so
        its presence marks a complete snapshot."""
        return (path / CKPT_FILE).exists() and (path / POSITION_FILE).exists()

    def _promote_interrupted(self) -> bool:
        """After a crash inside a swap, move the complete snapshot left under
        ``_latest.tmp`` (newer) or ``_latest.old`` to ``_latest``."""
        final = self._latest_dir()
        for cand in (final.with_name("_latest.tmp"), final.with_name("_latest.old")):
            if self._complete(cand):
                if final.exists():
                    shutil.rmtree(final)
                os.rename(cand, final)
                logger.warning("recovered an interrupted snapshot swap: promoted %s",
                               cand.name)
                return True
        return False

    def save_latest(self, trainer, epoch: int, next_batch: int = 0) -> None:
        """Full snapshot for exact resume at ``(epoch, next_batch)``."""
        opt = trainer.optimizer
        payload = {
            "models": {n: model_state(trainer, n) for n in trainer.model_names},
            "optimizer": None if opt is None else optimizer_state(trainer),
            "optimizer_count": 0 if opt is None else opt.count,
            "generators": generator_states(trainer),
        }
        meshlib.barrier()
        if meshlib.is_main_rank():
            self._write_latest(payload, epoch, next_batch)
        meshlib.barrier()

    def _write_latest(self, payload: dict, epoch: int, next_batch: int) -> None:
        final = self._latest_dir()
        tmp, old = final.with_name("_latest.tmp"), final.with_name("_latest.old")
        if not final.exists():
            self._promote_interrupted()
        for stale in (tmp, old):
            if stale.exists():
                shutil.rmtree(stale)
        tmp.mkdir(parents=True)
        _save_synced(payload, tmp / CKPT_FILE)
        (tmp / POSITION_FILE).write_text(
            json.dumps({"epoch": int(epoch), "next_batch": int(next_batch)}))
        if final.exists():
            os.rename(final, old)
        os.rename(tmp, final)
        if old.exists():
            shutil.rmtree(old)

    def restore_latest(self, trainer) -> Optional[Tuple[int, int]]:
        """Restore the latest snapshot; returns ``(epoch, next_batch)``, or
        None when there is none or it no longer fits the trainer (another
        model set or optimizer): callers then use ``restore_all``."""
        latest = self._latest_dir()
        if meshlib.is_main_rank() and not self._complete(latest):
            self._promote_interrupted()
        meshlib.barrier()
        if not self._complete(latest):
            return None
        payload = _load(latest / CKPT_FILE)
        try:
            for name in trainer.model_names:
                load_model_state(trainer, name, payload["models"][name])
            if trainer.optimizer is not None:
                load_optimizer_state(trainer, payload["optimizer"])
                trainer.optimizer.count = int(payload["optimizer_count"])
        except (KeyError, RuntimeError, ValueError) as exc:
            logger.warning("latest snapshot does not fit the trainer (%s: %s); "
                           "falling back to the best-metric checkpoints",
                           type(exc).__name__, exc)
            return None
        set_generator_states(trainer, payload["generators"])
        pos = json.loads((latest / POSITION_FILE).read_text())
        logger.info("restored latest snapshot at %s", pos)
        return int(pos["epoch"]), int(pos["next_batch"])

    @property
    def best(self) -> Dict:
        return dict(self._best)
