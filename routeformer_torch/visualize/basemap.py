"""Offline basemap for GPS plots (counterpart of
``routeformer_tpu/visualize/basemap.py``).

``add_basemap`` draws under the data either cached slippy-map tiles, a
directory in the ``{z}/{x}/{y}.png`` layout (the ``tile_dir`` argument or
``ROUTEFORMER_TILE_CACHE``; nothing is fetched), stitched in web-mercator
coordinates, or, when no tile covers the view, a drawn cartographic layer:
the OSM land tone, a labelled lat/lon graticule, a ground-metre scale bar
(mercator metres scaled by cos(latitude)) and a north arrow.

Tiles are decoded by Pillow (matplotlib's own image reader), not cv2, into
the uint8 RGB that the JAX package's ``cv2.imread`` + ``cvtColor`` gives an
8-bit PNG (alpha dropped, grey replicated), so ``imshow`` draws the same
pixels. The module imports no plotting package: it draws on the axes it is
given.
"""

import math
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from routeformer_torch.utils.logging import get_logger

logger = get_logger("visualize.basemap")

# Web-mercator constants (EPSG:3857).
_R = 6378137.0
_ORIGIN = math.pi * _R  # half world extent in meters

TILE_CACHE_ENV = "ROUTEFORMER_TILE_CACHE"


def mercator_to_lonlat(x: np.ndarray, y: np.ndarray):
    lon = np.degrees(np.asarray(x) / _R)
    lat = np.degrees(2.0 * np.arctan(np.exp(np.asarray(y) / _R)) - math.pi / 2)
    return lon, lat


def lonlat_to_mercator(lon: np.ndarray, lat: np.ndarray):
    x = np.radians(np.asarray(lon)) * _R
    y = _R * np.log(np.tan(math.pi / 4 + np.radians(np.asarray(lat)) / 2))
    return x, y


def _tile_index(x_m: float, y_m: float, zoom: int):
    """Web-mercator meters -> (tile_x, tile_y) at ``zoom`` (slippy grid)."""
    n = 2 ** zoom
    tx = (x_m + _ORIGIN) / (2 * _ORIGIN) * n
    ty = (_ORIGIN - y_m) / (2 * _ORIGIN) * n
    return tx, ty


def _tile_extent(tx: int, ty: int, zoom: int):
    """Mercator extent (x0, x1, y0, y1) of one tile."""
    n = 2 ** zoom
    size = 2 * _ORIGIN / n
    x0 = -_ORIGIN + tx * size
    y1 = _ORIGIN - ty * size
    return x0, x0 + size, y1 - size, y1


def _auto_zoom(bounds: Sequence[float], max_tiles: int = 16) -> int:
    """Largest zoom whose tile count over ``bounds`` stays bounded."""
    for zoom in range(19, -1, -1):
        tx0, ty1 = _tile_index(bounds[0], bounds[1], zoom)
        tx1, ty0 = _tile_index(bounds[2], bounds[3], zoom)
        n = (int(tx1) - int(tx0) + 1) * (int(ty1) - int(ty0) + 1)
        if n <= max_tiles:
            return zoom
    return 0


def _read_tile(path: Path) -> np.ndarray:
    """An 8-bit PNG tile as (H, W, 3) uint8 RGB, as ``cv2.imread(path,
    IMREAD_COLOR)`` then ``cvtColor(BGR2RGB)`` gives it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading the basemap tile {path} needs Pillow (matplotlib's "
                          "image reader), which cannot be imported") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)


def _draw_cached_tiles(ax, bounds, tile_dir: Path, zoom: Optional[int]) -> bool:
    """Stitch ``{z}/{x}/{y}.png`` tiles under the data. True when at least
    one tile was drawn."""
    if zoom is None:
        zoom = _auto_zoom(bounds)
    tx0, ty1 = _tile_index(bounds[0], bounds[1], zoom)
    tx1, ty0 = _tile_index(bounds[2], bounds[3], zoom)
    drew = False
    for tx in range(int(tx0), int(tx1) + 1):
        for ty in range(int(ty0), int(ty1) + 1):
            path = tile_dir / str(zoom) / str(tx) / f"{ty}.png"
            if not path.exists():
                continue
            try:
                img = _read_tile(path)
            except OSError:  # not an image: skipped, as cv2.imread's None is
                continue
            x0, x1, y0, y1 = _tile_extent(tx, ty, zoom)
            ax.imshow(
                img, extent=(x0, x1, y0, y1), origin="upper",
                interpolation="bilinear", zorder=0,
            )
            drew = True
    if drew:
        logger.info("basemap: drew cached tiles at zoom %d", zoom)
    return drew


def _nice_step(span: float, target: int = 5) -> float:
    """1-2-5 ladder step producing ~``target`` graticule lines."""
    raw = span / max(target, 1)
    mag = 10 ** math.floor(math.log10(max(raw, 1e-12)))
    for m in (1, 2, 5, 10):
        if m * mag >= raw:
            return m * mag
    return 10 * mag


def _draw_graticule(ax, bounds):
    """Labeled lat/lon graticule + scale bar + north arrow (the drawn
    cartographic fallback)."""
    x0, y0, x1, y1 = bounds[0], bounds[1], bounds[2], bounds[3]
    lon0, lat0 = mercator_to_lonlat(x0, y0)
    lon1, lat1 = mercator_to_lonlat(x1, y1)

    ax.set_facecolor("#f2efe9")  # OSM land tone

    lon_step = _nice_step(lon1 - lon0)
    lat_step = _nice_step(lat1 - lat0)
    lon_ticks = np.arange(
        math.ceil(lon0 / lon_step) * lon_step, lon1 + 1e-12, lon_step
    )
    lat_ticks = np.arange(
        math.ceil(lat0 / lat_step) * lat_step, lat1 + 1e-12, lat_step
    )
    for lon in lon_ticks:
        xm, _ = lonlat_to_mercator(lon, 0.0)
        ax.axvline(xm, color="#c8d0d8", linewidth=0.8, zorder=1)
        ax.annotate(
            f"{lon:.4f}°", (xm, y0), xytext=(2, 4),
            textcoords="offset points", fontsize=7, color="#7a8288",
            zorder=3,
        )
    for lat in lat_ticks:
        _, ym = lonlat_to_mercator(0.0, lat)
        ax.axhline(ym, color="#c8d0d8", linewidth=0.8, zorder=1)
        ax.annotate(
            f"{lat:.4f}°", (x0, ym), xytext=(4, 2),
            textcoords="offset points", fontsize=7, color="#7a8288",
            zorder=3,
        )

    # Scale bar: mercator meters -> ground meters via cos(mid latitude).
    mid_lat = math.radians((lat0 + lat1) / 2)
    ground_per_merc = math.cos(mid_lat)
    span_ground = (x1 - x0) * ground_per_merc
    bar_ground = _nice_step(span_ground, target=4)
    bar_merc = bar_ground / ground_per_merc
    bx = x0 + 0.05 * (x1 - x0)
    by = y0 + 0.05 * (y1 - y0)
    ax.plot(
        [bx, bx + bar_merc], [by, by], color="#333333", linewidth=2.5,
        zorder=3, solid_capstyle="butt",
    )
    label = (
        f"{bar_ground / 1000:g} km" if bar_ground >= 1000
        else f"{bar_ground:g} m"
    )
    ax.annotate(
        label, (bx + bar_merc / 2, by), xytext=(0, 4),
        textcoords="offset points", ha="center", fontsize=8,
        color="#333333", zorder=3,
    )

    # North arrow, top-right.
    nx = x0 + 0.95 * (x1 - x0)
    ny0 = y0 + 0.88 * (y1 - y0)
    ny1 = y0 + 0.95 * (y1 - y0)
    ax.annotate(
        "", (nx, ny1), (nx, ny0),
        arrowprops=dict(arrowstyle="-|>", color="#333333", linewidth=1.5),
        zorder=3,
    )
    ax.annotate(
        "N", (nx, ny1), xytext=(0, 3), textcoords="offset points",
        ha="center", fontsize=9, color="#333333", zorder=3,
    )


def add_basemap(
    ax,
    bounds: Sequence[float],
    tile_dir: Optional[os.PathLike] = None,
    zoom: Optional[int] = None,
):
    """Draw an offline basemap under the data (the ``ctx.add_basemap``
    role, reference plot.py:136-141).

    ``bounds`` is (x_min, y_min, x_max, y_max) in web-mercator meters.
    ``tile_dir`` (or the ``ROUTEFORMER_TILE_CACHE`` env var) points at a
    ``{z}/{x}/{y}.png`` tile mirror; when absent or empty for the view,
    the drawn graticule/scale layer is used.
    """
    tile_dir = tile_dir or os.environ.get(TILE_CACHE_ENV)
    if tile_dir is not None:
        if _draw_cached_tiles(ax, bounds, Path(tile_dir), zoom):
            return ax
        logger.info(
            "basemap: no cached tiles for this view under %s; drawing the "
            "graticule layer", tile_dir,
        )
    _draw_graticule(ax, bounds)
    return ax
