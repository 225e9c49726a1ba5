"""Timing and tracing (counterpart of ``routeformer_tpu/utils/profiling.py``).

``time_it`` and ``TimeIt`` log and aggregate wall time; when CUDA is in use
they synchronise the device before each clock read, so a timed region
covers the work it launched. ``device_trace`` is a ``torch.profiler``
trace of the CPU and, when present, the card, written for TensorBoard or
Perfetto; ``annotate`` names a region in it.
"""

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from routeformer_torch.utils.logging import get_logger

logger = get_logger("profiling")

_AGGREGATES: Dict[str, list] = defaultdict(list)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_it(fn=None, *, name: Optional[str] = None):
    """Decorator logging and aggregating a call's wall time."""

    def decorate(f):
        label = name or f.__qualname__

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            try:
                return f(*args, **kwargs)
            finally:
                _sync()
                dt = time.perf_counter() - t0
                _AGGREGATES[label].append(dt)
                logger.info("%s took %.4fs", label, dt)

        return wrapper

    return decorate(fn) if fn is not None else decorate


class TimeIt:
    """Context-manager timer; ``elapsed`` holds the seconds."""

    def __init__(self, name: str):
        self.name = name
        self.elapsed = 0.0

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed = time.perf_counter() - self._t0
        _AGGREGATES[self.name].append(self.elapsed)
        logger.info("%s took %.4fs", self.name, self.elapsed)
        return False


def timing_summary() -> Dict[str, Dict[str, float]]:
    """Count, total, mean and max of every timed label."""
    return {
        name: {"count": len(s), "total": sum(s), "mean": sum(s) / len(s), "max": max(s)}
        for name, s in _AGGREGATES.items()
    }


def reset_timing() -> None:
    _AGGREGATES.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` trace (CPU, and CUDA when available) of the body,
    written to ``log_dir`` for TensorBoard or Perfetto."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
    logger.info("device trace written to %s", log_dir)


def annotate(name: str):
    """A named region inside a ``device_trace``."""
    return torch.profiler.record_function(name)
