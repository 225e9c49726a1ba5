"""What a per-layer metric reads (``metrics/<name>.py``): each reader has
``read(ctx) -> float | None`` and returns None where it finds nothing to
read in this run (another cell's layer, a counter that disagrees with the
shapes, no trace)."""

import dataclasses
import importlib.util
from pathlib import Path
from typing import Optional

from benchmark.devtrace import Summary

METRICS = Path(__file__).resolve().parent / "metrics"


@dataclasses.dataclass
class Context:
    config: dict
    mix: dict
    units: str  # "steps" or "requests"
    traced_units: int
    trace: Summary
    counters: dict  # launch-counter deltas over the traced units
    unit_s: float  # wall seconds a unit, untraced part of the window
    shapes: dict  # {"input"|"target": {key: (shape, dtype)}} of one unit
    cache: dict = dataclasses.field(default_factory=dict)

    def frames_per_pass(self, length: int, step: int) -> int:
        """Frames of one view that a clip of ``length`` steps samples."""
        return len(range(length - 1, 0, -step))

    def pass_frames(self) -> list:
        """Frames through the video backbone per unit, one entry a pass
        (the input pass, and in training the target pass)."""
        cfg, g = self.config["model"], self.config["gps_backbone"]
        b = self.mix["batch"]
        lengths = [g["seq_len"]] + ([g["pred_len"]] if self.units == "steps" else [])
        step = cfg["output_fps"] // cfg["video_fps"]
        return [3 * b * self.frames_per_pass(n, step) for n in lengths]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = METRICS / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read(name: str, ctx: Context) -> Optional[float]:
    return reader(name)(ctx)
