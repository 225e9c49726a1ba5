"""The port's GPS map plots against the JAX package's, in one process on
the CPU: the drawn basemap (the same bytes, and the JAX test's golden
image under its own bound), the projection, cached ``{z}/{x}/{y}.png``
tiles written and read without cv2 (the same pixels), and the package
without matplotlib."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from routeformer_torch.visualize import basemap as port_basemap
from routeformer_torch.visualize import plot as port_plot

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "golden" / "gps_map.npz"


def demo_track():
    """The JAX test's short drive near Tuebingen."""
    t = np.linspace(0, 1, 40)
    return {"latitude": 48.52 + 0.001 * t + 0.0002 * np.sin(6 * t),
            "longitude": 9.05 + 0.0015 * t}


def _render(plot_module, **kwargs):
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    ax = plot_module.plot_gps_data_on_map(
        demo_track(), coordinate_system="EPSG:4326",
        figure_kwargs={"figsize": (5, 5), "frameon": False},
        plot_kwargs={"markersize": 12, "marker": "o", "color": "blue"}, **kwargs)
    fig = ax.get_figure()
    img = plot_module.render_figure_to_image(fig)
    plt.close(fig)
    return img


def test_drawn_map_is_the_jax_packages_bytes_and_golden():
    from routeformer_tpu.visualize import plot as jax_plot

    got, want = _render(port_plot), _render(jax_plot)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)
    golden = np.load(GOLDEN)["img"]
    assert got.shape == golden.shape
    assert float(np.abs(got.astype(int) - golden.astype(int)).mean()) < 3.0


def test_projection_and_tiles_match_jax():
    from routeformer_tpu.visualize import basemap as jax_basemap

    lon, lat = np.array([9.05, -120.0, 0.0]), np.array([48.52, -33.0, 80.0])
    x, y = port_basemap.lonlat_to_mercator(lon, lat)
    jx, jy = jax_basemap.lonlat_to_mercator(lon, lat)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    lon2, lat2 = port_basemap.mercator_to_lonlat(x, y)
    np.testing.assert_array_equal((lon2, lat2), jax_basemap.mercator_to_lonlat(x, y))
    np.testing.assert_allclose(lon2, lon, atol=1e-9)
    np.testing.assert_allclose(lat2, lat, atol=1e-9)
    bounds = (float(x[0]) - 300, float(y[0]) - 200, float(x[0]) + 400, float(y[0]) + 100)
    assert port_basemap._auto_zoom(bounds) == jax_basemap._auto_zoom(bounds)
    for zoom in (12, 15, 19):
        tx, ty = port_basemap._tile_index(float(x[0]), float(y[0]), zoom)
        assert (tx, ty) == jax_basemap._tile_index(float(x[0]), float(y[0]), zoom)
        assert port_basemap._tile_extent(int(tx), int(ty), zoom) == \
            jax_basemap._tile_extent(int(tx), int(ty), zoom)


def _write_tiles(root):
    """8-bit PNG tiles over the demo track's view at the zoom the plot
    picks, written by Pillow: RGB, RGBA (the alpha cv2.imread drops) and
    grey, each with a gradient."""
    from PIL import Image

    x, y = port_basemap.lonlat_to_mercator(demo_track()["longitude"],
                                           demo_track()["latitude"])
    bounds = (x.min() - 50, y.min() - 50, x.max() + 50, y.max() + 50)
    zoom = port_basemap._auto_zoom(bounds)
    tx0, ty1 = port_basemap._tile_index(bounds[0], bounds[1], zoom)
    tx1, ty0 = port_basemap._tile_index(bounds[2], bounds[3], zoom)
    ramp = np.add.outer(np.arange(256), np.arange(256)) // 2
    made = 0
    for tx in range(int(tx0), int(tx1) + 1):
        for ty in range(int(ty0), int(ty1) + 1):
            d = Path(root) / str(zoom) / str(tx)
            d.mkdir(parents=True, exist_ok=True)
            rgb = np.stack([ramp, 255 - ramp, np.full_like(ramp, 40 * made % 256)], -1)
            kind = made % 3
            if kind == 0:
                img = Image.fromarray(rgb.astype(np.uint8), "RGB")
            elif kind == 1:
                rgba = np.concatenate([rgb, np.full_like(ramp, 90)[..., None]], -1)
                img = Image.fromarray(rgba.astype(np.uint8), "RGBA")
            else:
                img = Image.fromarray(ramp.astype(np.uint8), "L")
            img.save(d / f"{ty}.png")
            made += 1
    return made


def test_cached_tiles_are_drawn_as_the_jax_package_draws_them(tmp_path, monkeypatch):
    """Tiles written without cv2 decode to the bytes JAX's cv2 read gives,
    and the two packages' maps over them are the same pixels (``source=``
    and ``ROUTEFORMER_TILE_CACHE``)."""
    import cv2

    from routeformer_tpu.visualize import plot as jax_plot

    assert _write_tiles(tmp_path) >= 3
    for path in sorted(tmp_path.rglob("*.png")):
        want = cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(port_basemap._read_tile(path), want)
    (next(tmp_path.rglob("*.png")).parent / "0.png").write_bytes(b"not a png")
    got = _render(port_plot, source=tmp_path)
    np.testing.assert_array_equal(got, _render(jax_plot, source=tmp_path))
    assert not np.array_equal(got, _render(port_plot))  # the tiles, not the graticule
    monkeypatch.setenv(port_basemap.TILE_CACHE_ENV, str(tmp_path))
    np.testing.assert_array_equal(_render(port_plot), got)


_NO_MATPLOTLIB = r"""
import sys
for name in list(sys.modules):
    if name.split(".")[0] in ("matplotlib", "PIL"):
        del sys.modules[name]
sys.modules["matplotlib"] = None
sys.modules["PIL"] = None
import numpy as np
import routeformer_torch.visualize as vis
frame = np.zeros((24, 32, 3), np.uint8)
out = vis.overlay_heatmap_on_frame(frame, [[0.5, 0.5]], sigma=4.0, device="cpu")
assert out.shape == frame.shape and out.any()
try:
    vis.plot_gps_data_on_map({"x": np.zeros(3), "y": np.zeros(3)})
    raise AssertionError("plotted without matplotlib")
except ImportError as e:
    assert "visualize/plot.py" in str(e) and "matplotlib" in str(e), e
from pathlib import Path
from routeformer_torch.visualize.basemap import _read_tile
try:
    _read_tile(Path("tile.png"))
    raise AssertionError("read a tile without Pillow")
except ImportError as e:
    assert "tile.png" in str(e), e
print("no matplotlib ok")
"""


def test_visualize_imports_and_overlays_without_matplotlib():
    out = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-3:] == ["no", "matplotlib", "ok"]


@pytest.mark.parametrize("columns", ["lonlat", "xy4326", "xy3857"])
def test_extract_xy_matches_jax(columns):
    from routeformer_tpu.visualize.plot import _extract_xy

    t = demo_track()
    if columns == "lonlat":
        data, system = t, "EPSG:3857"
    elif columns == "xy4326":
        data, system = {"x": t["longitude"], "y": t["latitude"]}, "EPSG:4326"
    else:
        data, system = {"x": t["longitude"] * 1e5, "y": t["latitude"] * 1e5}, "EPSG:3857"
    got, want = port_plot._extract_xy(data, system), _extract_xy(data, system)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError, match="latitude"):
        port_plot._extract_xy({"a": [1.0]}, system)
