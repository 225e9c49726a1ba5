"""GPS trajectory plots (counterpart of
``routeformer_tpu/visualize/plot.py``).

``plot_gps_data_on_map`` draws trajectories (web-mercator ``x``/``y``
columns, or ``latitude``/``longitude``, from a pandas-like frame or a dict
of arrays; optional view bounds and a padding offset) over the offline
basemap of ``visualize/basemap.py``: cached ``{z}/{x}/{y}.png`` tiles when
``source=`` or ``ROUTEFORMER_TILE_CACHE`` names a directory, else the
drawn cartographic layer. ``render_figure_to_image`` rasterises a figure
to an RGB array. matplotlib is imported when a plot is drawn, and its
absence raises ``ImportError`` naming this file.
"""

import io
from typing import Optional

import numpy as np

from routeformer_torch.io.resample import convert_gps_coordinates
from routeformer_torch.utils.logging import get_logger

logger = get_logger("visualize.plot")


def _extract_xy(gps_data, coordinate_system: str):
    cols = (
        gps_data.columns
        if hasattr(gps_data, "columns")
        else list(gps_data.keys())
    )
    get = (lambda c: gps_data[c].values) if hasattr(gps_data, "columns") else (
        lambda c: np.asarray(gps_data[c])
    )
    if "x" in cols and "y" in cols:
        x, y = get("x"), get("y")
        if coordinate_system == "EPSG:4326":
            # x/y columns in 4326 mean lon/lat; project to mercator meters
            xy = convert_gps_coordinates(np.stack([y, x], axis=-1))
            return xy[:, 0], xy[:, 1]
        return x, y
    if "latitude" in cols and "longitude" in cols:
        xy = convert_gps_coordinates(
            np.stack([get("latitude"), get("longitude")], axis=-1)
        )
        return xy[:, 0], xy[:, 1]
    raise ValueError(
        "gps_data must contain either the columns 'x' and 'y', "
        "or 'latitude' and 'longitude'"
    )


def plot_gps_data_on_map(
    gps_data,
    bounds_gdf=None,
    bounds=None,
    coordinate_system: str = "EPSG:3857",
    figure_kwargs: Optional[dict] = None,
    plot_kwargs: Optional[dict] = None,
    ax=None,
    offset: float = 50,
    source=None,
):
    """Plot GPS trajectories (reference plot.py:14-143).

    Returns the matplotlib Axes.
    """
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"plot_gps_data_on_map ({__file__}) draws with matplotlib, "
                          "which cannot be imported on this host") from e

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    figure_kwargs = figure_kwargs or {"figsize": (10, 10), "frameon": False}
    plot_kwargs = plot_kwargs or {"markersize": 50, "marker": "o", "color": "blue"}

    x, y = _extract_xy(gps_data, coordinate_system)

    if ax is None:
        _, ax = plt.subplots(**figure_kwargs)

    markersize = plot_kwargs.pop("markersize", 50)
    ax.scatter(x, y, s=markersize, **plot_kwargs)

    if bounds is not None:
        view = (bounds[0], bounds[1], bounds[2], bounds[3])
    else:
        bx, by = (x, y)
        if bounds_gdf is not None:
            bx, by = _extract_xy(bounds_gdf, coordinate_system)
        view = (
            bx.min() - offset, by.min() - offset,
            bx.max() + offset, by.max() + offset,
        )
    ax.set_xlim(view[0], view[2])
    ax.set_ylim(view[1], view[3])

    # Offline basemap (the ctx.add_basemap role, reference plot.py:136-141):
    # cached {z}/{x}/{y}.png tiles when a mirror is configured (`source` as
    # a path, or ROUTEFORMER_TILE_CACHE), else the drawn graticule/scale
    # cartographic layer.
    from routeformer_torch.visualize.basemap import add_basemap

    add_basemap(ax, view, tile_dir=source)
    ax.set_aspect("equal", adjustable="box")
    return ax


def render_figure_to_image(fig) -> np.ndarray:
    """Rasterize a matplotlib figure to an (H, W, 3) uint8 array
    (reference plot.py:146-170)."""
    buf = io.BytesIO()
    fig.savefig(buf, format="raw", dpi=fig.dpi)
    buf.seek(0)
    w, h = fig.canvas.get_width_height()
    img = np.frombuffer(buf.getvalue(), dtype=np.uint8).reshape(h, w, 4)
    return img[:, :, :3].copy()
