"""The native (C++) GPMF GPS walker (counterpart of
``routeformer_tpu/io/gpmf_native.py``) over the port's copy of the walker,
``csrc/gpmf.cpp``, built by ``io/native.py`` at first use.

The walker replaces the Python KLV loop of ``io/gpmf.py`` on the dataset's
index path; the timestamp fixing and the dilution filter stay in Python and
are shared, so both walkers give the same points. A library that cannot be
built or loaded raises ``ImportError`` (``io/native.py``). On a stream the
walker calls non-canonical (a GPSU text of another shape) it returns None,
and ``gpmf.build_gps_points`` walks that stream in Python for the exact
semantics, as the JAX package does.
"""

import ctypes
import datetime
import math
from typing import List, Optional, Tuple

import numpy as np

from routeformer_torch.io import native
from routeformer_torch.io.gpmf import GPSPoint, fix_timestamps, filter_dilution

ABI_VERSION = 2


def _load() -> ctypes.CDLL:
    lib = native.library("gpmf")
    lib.gpmf_extract_gps.restype = ctypes.c_long
    lib.gpmf_extract_gps.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_long,
    ]
    lib.gpmf_native_abi_version.restype = ctypes.c_int
    if lib.gpmf_native_abi_version() != ABI_VERSION:
        raise ImportError(f"libgpmf: ABI {lib.gpmf_native_abi_version()}, expected "
                          f"{ABI_VERSION}")
    return lib


def extract_gps_raw(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Raw extraction: ``(points (N, 5) [lat, lon, alt, speed, dop], times
    (N,))`` with NaN times for the points no GPSU stamps, or None when the
    stream is non-canonical (the walker returns -1)."""
    lib = _load()
    max_points = max(64, len(data) // 20 + 16)  # GPS5 rows are 20 bytes
    out = np.empty((max_points, 5), dtype=np.float64)
    out_time = np.empty(max_points, dtype=np.float64)
    n = lib.gpmf_extract_gps(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out_time.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_points)
    if n < 0:
        return None
    return out[:n], out_time[:n]


def native_available() -> bool:
    """Whether ``csrc/gpmf.cpp`` builds and loads here. The walker itself
    does not fall back: ``extract_gps_raw`` raises the build's or the
    load's ``ImportError``."""
    try:
        _load()
    except ImportError:
        return False
    return True


def fix_timestamps_array(times: np.ndarray) -> np.ndarray:
    """Vectorized equivalent of ``gpmf.fix_timestamps``/``estimate_fps`` on
    posix-seconds arrays (NaN = missing): estimates the per-gap rate, drops
    stamps outside the 17.5-18.5 Hz plausibility window, fills missing stamps
    forward (and the head backward) at the estimated rate, 18.17 Hz default.
    """
    times = times.astype(np.float64).copy()
    n = len(times)
    if n == 0:
        return times

    valid_idx = np.flatnonzero(~np.isnan(times))
    # per-gap fps with the plausibility rejection (drops the EARLIER stamp,
    # matching the reference's behavior)
    fps_gap = np.full(max(len(valid_idx) - 1, 0), np.nan)
    if len(valid_idx) >= 2:
        counts = np.diff(valid_idx).astype(np.float64)
        dts = np.diff(times[valid_idx])
        with np.errstate(divide="ignore", invalid="ignore"):
            est = np.where(dts != 0, counts / dts, np.nan)
        bad = np.isnan(est) | (est > 18.5) | (est < 17.5)
        times[valid_idx[:-1][bad]] = np.nan
        fps_gap = np.where(bad, np.nan, est)

    # per-point fps: gap estimates spread over their ranges, 18.17 fallback
    fps = np.full(n, np.nan)
    if len(valid_idx) >= 2:
        reps = np.diff(valid_idx)
        fps[valid_idx[0] : valid_idx[-1]] = np.repeat(fps_gap, reps)
    # backward fill of NaN fps (reference fills from the next valid estimate)
    rev_valid = ~np.isnan(fps[::-1])
    rev_idx = np.where(rev_valid, np.arange(n), -1)
    rev_prev = np.maximum.accumulate(rev_idx)
    fps_rev = fps[::-1]
    filled_rev = np.where(rev_prev >= 0, fps_rev[np.maximum(rev_prev, 0)], 18.17)
    fps = filled_rev[::-1].copy()

    valid_idx = np.flatnonzero(~np.isnan(times))
    if valid_idx.size == 0:
        return times
    # forward fill from the previous valid stamp at the local rate
    arange = np.arange(n)
    prev = np.maximum.accumulate(np.where(~np.isnan(times), arange, -1))
    missing = np.isnan(times) & (prev >= 0)
    times[missing] = (
        times[np.maximum(prev, 0)][missing]
        + (arange - prev)[missing] / fps[missing]
    )
    # head backfill from the first valid stamp
    first = valid_idx[0]
    if first > 0:
        head = np.arange(first)
        times[head] = times[first] - (first - head) / fps[head]
    return times


def build_gps_arrays(
    data: bytes, dilution_threshold: float = 500.0
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Array-level fast path: ``(values (N, 4) [lat, lon, alt, speed],
    posix_times (N,), dilutions (N,))`` filtered by dilution, with no
    per-point Python objects; None on a non-canonical stream."""
    raw = extract_gps_raw(data)
    if raw is None:
        return None
    values, times = raw
    times = fix_timestamps_array(times)
    keep = values[:, 4] < dilution_threshold
    return values[keep, :4], times[keep], values[keep, 4]


def build_gps_points_native(
    data: bytes, dilution_threshold: float = 500.0
) -> Optional[Tuple[List[GPSPoint], List[float]]]:
    """``gpmf.build_gps_points`` through the native walker; None on a
    non-canonical stream."""
    raw = extract_gps_raw(data)
    if raw is None:
        return None
    values, times = raw
    points: List[GPSPoint] = []
    dilutions: List[float] = []
    for (lat, lon, alt, spd, dop), t in zip(values, times):
        stamp = (None if math.isnan(t) else datetime.datetime.fromtimestamp(
            t, datetime.timezone.utc).replace(tzinfo=None))
        points.append(GPSPoint(lat, lon, alt, stamp, spd))
        dilutions.append(float(dop))
    fix_timestamps(points)
    return filter_dilution(points, dilutions, dilution_threshold)
