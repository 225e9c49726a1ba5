"""The gaze heatmaps against the JAX package on the CPU:
``ops.heatmap.rasterize_gaze_heatmap`` and its overlay, and
``visualize.gaze.overlay_heatmap_on_frame``, at (B 3, N 40, H 54, W 96).

Tolerances: heatmaps and the ops overlay 1e-6 of the max (f32; the
contraction over the points sums in another order). The visualize overlay
on uint8 frames: at most 1 level, because the jet ramp truncates
``255 * value`` to uint8, so a heatmap one f32 rounding apart can fall on
the other side of a level."""

import numpy as np
import pytest
import torch

from routeformer_torch.ops import heatmap as port
from routeformer_torch.visualize import gaze as port_gaze

B, N, H, W = 3, 40, 54, 96


def _points(seed=0):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, W + 10, (B, N)), rng.uniform(-10, H + 10, (B, N))], -1)
    return pts.astype(np.float32), rng.uniform(0.2, 1.0, (B, N)).astype(np.float32)


def _jax(points, weights=None, sigma=10.0):
    from routeformer_tpu.ops.heatmap import rasterize_gaze_heatmap

    return np.asarray(rasterize_gaze_heatmap(points, H, W, sigma=sigma, weights=weights))


def _port(points, weights=None, sigma=10.0):
    return port.rasterize_gaze_heatmap(points, H, W, sigma=sigma, weights=weights,
                                       device="cpu").numpy()


@pytest.mark.parametrize("weighted", [False, True])
def test_heatmap_matches_jax(weighted):
    points, weights = _points()
    weights = weights if weighted else None
    want, got = _jax(points, weights), _port(points, weights)
    assert got.shape == want.shape == (B, H, W) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # a tensor input stays on its device; sigma changes the map as in JAX
    t = port.rasterize_gaze_heatmap(torch.from_numpy(points), H, W, sigma=4.0)
    assert t.device.type == "cpu"
    assert np.abs(t.numpy() - _jax(points, sigma=4.0)).max() <= 1e-6


def test_heatmap_nan_point_poisons_its_item_as_in_jax():
    """One NaN point makes its whole item NaN in both packages (the JAX
    docstring's "contribute ~0" does not hold); the other items agree."""
    points, _ = _points(1)
    points[0, 5] = np.nan
    want, got = _jax(points), _port(points)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[0]).all() and not np.isnan(want[1:]).any()
    assert np.abs(got[1:] - want[1:]).max() <= 1e-6 * np.abs(want[1:]).max()


def test_heatmap_far_points_give_zero_maps():
    points = np.full((B, N, 2), 1e4, np.float32)
    want, got = _jax(points), _port(points)
    assert not want.any() and not got.any()


def test_ops_overlay_matches_jax():
    from routeformer_tpu.ops.heatmap import overlay_heatmap_on_frame

    points, _ = _points(2)
    heat = _jax(points)[0]
    frame = np.random.default_rng(3).uniform(size=(H, W, 3)).astype(np.float32)
    want = np.asarray(overlay_heatmap_on_frame(frame, heat, alpha=0.4))
    got = port.overlay_heatmap_on_frame(frame, heat, alpha=0.4, device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_visualize_overlay_matches_jax():
    from routeformer_tpu.visualize.gaze import _jet, overlay_heatmap_on_frame

    rng = np.random.default_rng(4)
    frame = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    gaze = rng.uniform(0.1, 0.9, (N, 2))
    want = overlay_heatmap_on_frame(frame, gaze, sigma=6.0)
    got = port_gaze.overlay_heatmap_on_frame(frame, gaze, sigma=6.0, device="cpu")
    assert got.dtype == np.uint8 and got.shape == frame.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != frame).any()  # the blend reached some pixels
    values = np.linspace(0, 1, 1001, dtype=np.float32)
    np.testing.assert_array_equal(port_gaze._jet(values), _jet(values))
