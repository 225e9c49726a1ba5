"""Metric streaming to JSON lines (counterpart of
``routeformer_tpu/train/logging.py``). The run's config is written beside
the stream. Weights & Biases is not ported (``ROADMAP.md`` §1: not queued): the
card has no network, so ``use_wandb=True`` raises instead of logging
elsewhere than asked."""

import json
import time
from pathlib import Path
from typing import Dict, Optional

from routeformer_torch.utils.logging import get_logger

logger = get_logger("train.metrics")


def _to_jsonable(obj):
    if hasattr(obj, "to_dict"):
        return obj.to_dict()
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


class MetricsLogger:
    """Appends one JSON record per ``log`` call to
    ``log_dir/<experiment>.metrics.jsonl``."""

    def __init__(self, log_dir, experiment: str = "run", config: Optional[dict] = None,
                 use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError(
                "Weights & Biases logging is not ported (ROADMAP.md §1: not queued); "
                "metrics go to the JSON-lines stream")
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / f"{experiment}.metrics.jsonl"
        if config is not None:
            (self.log_dir / f"{experiment}.config.json").write_text(
                json.dumps(_to_jsonable(config), indent=2, default=str))
        self._fh = open(self.path, "a")

    def log(self, metrics: Dict, step: int, split: str = "train") -> None:
        record = {"time": time.time(), "step": step, "split": split,
                  **{k: float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
