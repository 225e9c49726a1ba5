"""GPS resampling and coordinate conversion, host-side numpy/scipy
(counterpart of ``routeformer_tpu/io/resample.py``).

Capability parity with the reference's GPS resampling
(``routeformer/io/dataset.py``):

- :func:`convert_gps_coordinates` — EPSG:4326 (lat/lon) -> EPSG:3857 (web
  mercator meters). The reference goes through pyproj (dataset.py:2648-2663);
  the spherical web-mercator formulas are closed-form and reproduce pyproj's
  EPSG:3857 to machine precision.
- :func:`pchip_resample` — PChip interpolation onto an output-fps grid with
  ffill/bfill edge handling (``_interpolate_gps`` :855-895).
- :func:`smooth_resample` — smoothing-spline interpolation weighted by
  1/dilution², the csaps path (``_smoothly_interpolate_gps`` :2059-2080),
  implemented with scipy's smoothing spline (csaps is not available here).
"""

from typing import Tuple

import numpy as np

_EARTH_RADIUS = 6378137.0  # WGS84 / web-mercator sphere radius


def convert_gps_coordinates(gps_data: np.ndarray) -> np.ndarray:
    """(N, 2) [latitude, longitude] degrees -> (N, 2) web-mercator [x, y] m."""
    gps_data = np.asarray(gps_data, dtype=np.float64)
    lat = np.radians(gps_data[:, 0])
    lon = np.radians(gps_data[:, 1])
    x = _EARTH_RADIUS * lon
    y = _EARTH_RADIUS * np.log(np.tan(np.pi / 4 + lat / 2))
    return np.stack([x, y], axis=-1)


def inverse_gps_coordinates(xy: np.ndarray) -> np.ndarray:
    """(N, 2) web-mercator [x, y] m -> (N, 2) [latitude, longitude] degrees."""
    xy = np.asarray(xy, dtype=np.float64)
    lon = np.degrees(xy[:, 0] / _EARTH_RADIUS)
    lat = np.degrees(2 * np.arctan(np.exp(xy[:, 1] / _EARTH_RADIUS)) - np.pi / 2)
    return np.stack([lat, lon], axis=-1)


def pchip_resample(
    timestamps: np.ndarray,
    values: np.ndarray,
    origin_time: float,
    duration: float,
    output_fps: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """PChip-resample onto the [origin, origin+duration] grid at output_fps.

    Returns ``(grid_timestamps, interpolated_values)``; out-of-range points
    are forward/backward filled (the reference's ffill().bfill()).
    """
    from scipy import interpolate

    order = np.argsort(timestamps)
    timestamps = np.asarray(timestamps, dtype=np.float64)[order]
    values = np.asarray(values, dtype=np.float64)[order]

    interpolator = interpolate.PchipInterpolator(
        timestamps, values, extrapolate=False
    )
    grid = np.arange(
        origin_time, origin_time + duration + 1.0 / output_fps, 1.0 / output_fps
    )
    out = interpolator(grid)

    # ffill then bfill along axis 0
    out = np.asarray(out)
    mask = np.isnan(out[:, 0]) if out.ndim > 1 else np.isnan(out)
    if mask.any():
        valid = np.where(~mask)[0]
        if valid.size:
            idx = np.clip(
                np.searchsorted(valid, np.arange(len(out)), side="right") - 1,
                0,
                valid.size - 1,
            )
            out = out[valid[idx]]
    return grid, out


def smooth_resample(
    timestamps: np.ndarray,
    values: np.ndarray,
    dilutions: np.ndarray,
    start: float,
    end: float,
    output_fps: float,
) -> np.ndarray:
    """Smoothing-spline resample weighted by 1/dilution²
    (reference dataset.py:2059-2080)."""
    from scipy.interpolate import make_smoothing_spline

    timestamps = np.asarray(timestamps, dtype=np.float64)
    order = np.argsort(timestamps)
    timestamps = timestamps[order] + 1e-6 * np.arange(len(timestamps))
    values = np.asarray(values, dtype=np.float64)[order]
    weights = (1.0 / np.asarray(dilutions, dtype=np.float64)[order]) ** 2

    grid = np.arange(start, end, 1.0 / output_fps)
    out = np.empty((len(grid), values.shape[1]))
    for col in range(values.shape[1]):
        spline = make_smoothing_spline(timestamps, values[:, col], w=weights)
        out[:, col] = spline(grid)
    return out
