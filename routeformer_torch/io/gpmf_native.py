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
