"""Timing and tracing (counterpart of ``routeformer_tpu/utils/profiling.py``).

**Spans.** ``span(name)`` (also ``annotate``) is a context manager that
marks one of the program's layer boundaries: ``rf.train_step``,
``rf.serve.request``, ``rf.video_backbone`` and the others that
``PERF.md`` lists. A span is on while the torch profiler records in this
process, or in every call once the operator sets ``ROUTEFORMER_TRACE=1``
(read once at import into the module flag ``enabled``, which tests may
set). Off, a span reads those two flags and returns a shared null context:
no ``record_function``, no CUDA event, no clock read. Under
``torch.compiler.is_compiling()`` (``torch.export``, ``torch.compile``) it
is a no-op too, so an exported program carries no span.

On, a span reads ``time.perf_counter_ns`` at entry and exit, records a
timing ``torch.cuda.Event`` on the current stream at entry and exit once
CUDA is in use, and opens ``torch.profiler.record_function(name)`` while
the profiler records, so the span shows on the device trace's own clock
and an idle gap of the device can be named after the program's innermost
span. Each span knows its parent (the span open around it on this thread)
and its unit (the ordinal of its root span, shared by every span of one
step or request); ``recent_spans()`` gives the last ``RECENT`` finished
spans with both.

**The table.** Per name: the count, the host total and host self time
(the duration less the part covered by its child spans), and the device
total and device self time from the events. The device intervals are read
lazily: ``timing_summary()`` synchronises and reads the pending events;
while the program runs, the finished ones are read (``Event.query``) once
more than ``PENDING_LIMIT`` wait, so a long traced run holds bounded
memory. ``time_it`` and ``TimeIt`` write host times into the same table;
they synchronise the device before each clock read, so a timed region
covers the work it launched. ``reset_timing()`` clears the table.

``device_trace`` is a ``torch.profiler`` trace of the CPU and, when
present, the card, written for TensorBoard or Perfetto; the spans inside
it are its named ranges.
"""

import collections
import contextlib
import functools
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from routeformer_torch.utils.logging import get_logger

logger = get_logger("profiling")

enabled = os.environ.get("ROUTEFORMER_TRACE") == "1"
PENDING_LIMIT = 256  # finished spans whose device interval is not read yet
RECENT = 4096  # finished spans kept for ``recent_spans``

_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()
_LOCAL = threading.local()
_UNITS = itertools.count()
_PENDING: collections.deque = collections.deque()
_RECENT: collections.deque = collections.deque(maxlen=RECENT)


class _Entry:
    __slots__ = ("count", "host", "host_self", "host_max", "device", "device_self",
                 "device_count")

    def __init__(self):
        self.count = self.device_count = 0
        self.host = self.host_self = self.host_max = self.device = self.device_self = 0.0


_TABLE: Dict[str, _Entry] = {}


def _add_host(name: str, seconds: float, self_seconds: float) -> None:
    with _LOCK:
        entry = _TABLE.setdefault(name, _Entry())
        entry.count += 1
        entry.host += seconds
        entry.host_self += self_seconds
        entry.host_max = max(entry.host_max, seconds)


class Span:
    """One span; made by ``span(name)`` only while tracing is on.
    ``parent`` is the enclosing span on this thread (or None: a root),
    ``unit`` the ordinal of its root, ``host_s`` and ``device_s`` its
    durations once it has ended and, for the device, been read."""

    __slots__ = ("name", "parent", "unit", "host_s", "device_s", "_t0", "_range", "_events",
                 "_child_host", "_child_device")

    def __init__(self, name: str):
        self.name = name
        self.host_s = self.device_s = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.unit = next(_UNITS) if self.parent is None else self.parent.unit
        self._child_host = self._child_device = 0.0
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._events = None
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        stack.append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _stack().pop()
        if self._events is not None:
            self._events[1].record()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.host_s = (t1 - self._t0) * 1e-9
        if self.parent is not None:
            self.parent._child_host += self.host_s
        _add_host(self.name, self.host_s, self.host_s - self._child_host)
        _RECENT.append(self)
        if self._events is not None:
            _PENDING.append(self)
            if len(_PENDING) > PENDING_LIMIT:
                _read_device(wait=False)
        return False


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def _read_device(wait: bool) -> None:
    """Read the device intervals of the pending spans, oldest first (a
    child ends, and is read, before its parent); without ``wait``, up to
    the first whose exit the device has not reached yet."""
    with _LOCK:
        while _PENDING:
            s = _PENDING[0]
            start, end = s._events
            if wait:
                end.synchronize()
            elif not end.query():
                break
            _PENDING.popleft()
            s._events = None
            s.device_s = start.elapsed_time(end) * 1e-3
            if s.parent is not None:
                s.parent._child_device += s.device_s
            entry = _TABLE.get(s.name)
            if entry is not None:  # else cleared by ``reset_timing`` meanwhile
                entry.device += s.device_s
                entry.device_self += s.device_s - s._child_device
                entry.device_count += 1


def span(name: str):
    """A span named ``name`` while tracing is on (the torch profiler
    records, or ``enabled``), else a shared null context."""
    if not (enabled or _autograd_profiler._is_profiler_enabled) or torch.compiler.is_compiling():
        return _NULL
    return Span(name)


annotate = span


def recent_spans() -> List[Span]:
    """The last ``RECENT`` finished spans, oldest first, their device
    intervals read (this synchronises with the device)."""
    _read_device(wait=True)
    return list(_RECENT)


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
                _add_host(label, dt, dt)
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
        _add_host(self.name, self.elapsed, self.elapsed)
        logger.info("%s took %.4fs", self.name, self.elapsed)
        return False


def timing_summary() -> Dict[str, Dict[str, float]]:
    """Per name, in seconds: ``count``, ``total``, ``mean``, ``max`` and
    ``self`` of the host times, and ``device_total`` and ``device_self``
    where every span of the name has a device interval. Synchronises with
    the device to read the pending intervals."""
    _read_device(wait=True)
    out = {}
    with _LOCK:
        for name, e in _TABLE.items():
            row = {"count": e.count, "total": e.host, "mean": e.host / e.count,
                   "max": e.host_max, "self": e.host_self}
            if e.device_count == e.count:
                row.update(device_total=e.device, device_self=e.device_self)
            out[name] = row
    return out


def reset_timing() -> None:
    """Clear the table, the pending device intervals and the recent spans."""
    with _LOCK:
        _TABLE.clear()
        _PENDING.clear()
        _RECENT.clear()


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
