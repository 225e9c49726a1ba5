"""The port's device image ops (``routeformer_torch/ops/image.py``: ``remap``,
``undistort_video``, ``undistort_image_numpy``, ``resize_video``) and its
stitcher (``io/stitcher.py``) against the JAX package's on the CPU, and
``GEMDataset(stitch_videos=True)`` against the JAX dataset on the JAX
fixture's recording.

Limits: ``remap`` and ``undistort_video`` within 1e-5 relative to the
frames' maximum (f32 lerps, XLA may fuse them); ``undistort_image_numpy``
(the lerps truncated to uint8) within 1, at least 99.99 % of the values
exact (measured: 2 of 62,208 differ); ``resize_video`` (``jax.image.resize`` bilinear,
antialiased when it shrinks) within ``RESIZE_TOL`` relative, measured;
the stitcher's method the same, its homography within 1e-6 relative, its
canvas within 1e-5 absolute; the stitched stream (float16) within one
float16 ulp of 1 (9.8e-4)."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gem_fixture import build_gem_fixture
from routeformer_torch.io.dataset import GEMDataset
from routeformer_torch.io.stitcher import ImageStitcher
from routeformer_torch.ops import image as port_image
from routeformer_tpu.io.dataset import GEMDataset as JaxGEMDataset
from routeformer_tpu.io.stitcher import ImageStitcher as JaxImageStitcher
from routeformer_tpu.ops import image as jax_image
from test_stitcher_envelope import (
    _gt_homography,
    _low_contrast,
    _low_texture,
    _make_right,
    _textured,
)

REMAP_RTOL = 1e-5
IMAGE_EXACT_SHARE = 0.9999
RESIZE_TOL = 1e-5
H_RTOL = 1e-6
CANVAS_TOL = 1e-5
STITCHED_TOL = 2.0 ** -10


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def test_remap_matches_jax():
    """Frames (N, H, W, C) at a grid reaching past every border."""
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 255, (3, 20, 28, 3)).astype(np.float32)
    grid = np.stack([rng.uniform(-3, 31, (17, 23)), rng.uniform(-3, 23, (17, 23))],
                    axis=-1).astype(np.float32)
    got = port_image.remap(torch.from_numpy(frames), torch.from_numpy(grid))
    want = jax_image.remap(jnp.asarray(frames), jnp.asarray(grid))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= REMAP_RTOL
    uint8 = frames.astype(np.uint8)
    got = port_image.remap(torch.from_numpy(uint8), torch.from_numpy(grid))
    assert _rel(got.numpy(), jax_image.remap(jnp.asarray(uint8), jnp.asarray(grid))) <= REMAP_RTOL


def test_undistort_matches_jax():
    """The GEM GoPro calibration at a small frame: the video on its device,
    and the host image (the same bits)."""
    k = GEMDataset.LEFT_VIDEO_CAMERA_INTRINSICS / 20.0
    k[2, 2] = 1.0
    d = GEMDataset.LEFT_VIDEO_DISTORTION_COEFFICIENTS
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (2, 108, 192, 3), dtype=np.uint8)
    got = port_image.undistort_video(torch.from_numpy(frames), k, d)
    assert _rel(got.numpy(), jax_image.undistort_video(jnp.asarray(frames), k, d)) <= REMAP_RTOL
    got = port_image.undistort_image_numpy(frames[0], k, d).astype(np.int16)
    diff = np.abs(got - jax_image.undistort_image_numpy(frames[0], k, d).astype(np.int16))
    assert diff.max() <= 1 and (diff == 0).mean() >= IMAGE_EXACT_SHARE, (
        diff.max(), (diff == 0).mean())


@pytest.mark.parametrize("out_hw", [(27, 48), (13, 20), (216, 384), (80, 100)],
                         ids=["down_4", "down_odd", "up_2", "mixed"])
def test_resize_video_matches_jax(out_hw):
    frames = np.random.default_rng(2).uniform(0, 1, (2, 108, 192, 3)).astype(np.float32)
    got = port_image.resize_video(torch.from_numpy(frames), out_hw)
    want = jax_image.resize_video(jnp.asarray(frames), out_hw)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= RESIZE_TOL


CASES = {  # name: (frame, homography), each pair stitched by both packages
    "orb": (_textured, (5.0, 2e-4)),
    "dense": (_low_contrast, (5.0, 2e-4)),
    "side-by-side": (_low_texture, (10.0, 5e-4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stitcher_matches_jax(case):
    """The envelope suite's cases: sparse (ORB), the dense NCC fallback and
    the side-by-side degradation: the same method, homography and canvas."""
    make, (rot, persp) = CASES[case]
    left = make()
    right = _make_right(left, _gt_homography(rot, persp))
    mine, ref = ImageStitcher(device="cpu"), JaxImageStitcher()
    got, want = mine.stitch_pair(left, right), ref.stitch_pair(left, right)
    assert mine.last_method == ref.last_method == case
    np.testing.assert_allclose(mine._cached_h, ref._cached_h, rtol=H_RTOL,
                               atol=H_RTOL * np.abs(ref._cached_h).max())
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CANVAS_TOL)


def test_stitch_sequence_reuses_and_degrades_as_jax(monkeypatch):
    """A sequence whose middle frames carry no structure: the cached
    homography reused, then the retry period, as the JAX stitcher."""
    for cls in (ImageStitcher, JaxImageStitcher):
        monkeypatch.setattr(cls, "RETRY_PERIOD", 2)
    h = _gt_homography(5.0, 0.0)
    base, blank = _textured(), _low_texture(seed=3)
    lefts = [base, blank, base, base]
    rights = [_make_right(f, h) for f in lefts]
    mine, ref = ImageStitcher(device="cpu"), JaxImageStitcher()
    methods = []
    for i, (lf, rf) in enumerate(zip(lefts, rights)):
        reuse = i not in (0, 1)
        got, want = mine.stitch_pair(lf, rf, reuse=reuse), ref.stitch_pair(lf, rf, reuse=reuse)
        np.testing.assert_allclose(got, want, rtol=0, atol=CANVAS_TOL)
        assert mine.last_method == ref.last_method
        methods.append(mine.last_method)
    assert methods == ["orb", "reuse-cached", "reuse-cached", "orb"]


@pytest.mark.parametrize("shape", [(1, 1, 3), (0, 4, 3), (4, 0, 3)])
def test_stitch_pair_degrades_on_frames_cv2_refuses(shape):
    """Frames cv2 raises ``cv2.error`` on (ORB on a 1 x 1 frame, ``cvtColor``
    on an empty one): ``stitch_pair`` keeps its contract and places the pair
    side by side, as for a ``ValueError`` (the JAX stitcher raises here)."""
    left = np.full(shape, 7, np.uint8)
    right = np.full(shape, 9, np.uint8)
    mine = ImageStitcher(device="cpu")
    got = mine.stitch_pair(left, right)
    assert mine.last_method == "side-by-side" and mine._degraded
    want = np.eye(3)
    want[0, 2] = shape[1]
    np.testing.assert_array_equal(mine._cached_h, want)
    assert got.shape == (shape[0], 2 * shape[1], 3) and got.dtype == np.float32


def test_stitcher_needs_cv2_and_a_device(monkeypatch):
    """No cv2: ``ImportError`` naming it. No device named on a host without
    a card: the CUDA error, not a quiet CPU warp."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ImageStitcher()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        ImageStitcher(device="cpu")


@pytest.fixture(scope="module")
def gem_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gem_stitch")
    build_gem_fixture(root, duration_s=16.0)
    return root


@pytest.mark.parametrize("video_dtype", ["uint8", "float16"])
def test_gem_dataset_stitches_as_jax(gem_root, video_dtype):
    """``GEMDataset(stitch_videos=True)``: the same keys, and the stitched
    stream (float16, double width) within one float16 ulp of 1; the other
    streams as without stitching (``test_torch_gem_dataset.py``)."""
    kw = dict(root=gem_root, split=["001"], min_pci=None, output_fps=5,
              gopro_scaling_factor=0.5, front_scaling_factor=0.6, stitch_videos=True,
              video_dtype=video_dtype)
    mine = GEMDataset(**kw, stitch_device="cpu")
    ref = JaxGEMDataset(**kw)
    assert len(mine) == len(ref) >= 1
    a, b = mine[0], ref[0]
    for phase in ("train", "target"):
        assert sorted(a[phase]) == sorted(b[phase])
        got, want = a[phase]["stitched_video"], b[phase]["stitched_video"]
        assert got.dtype == want.dtype == np.float16 and got.shape == want.shape
        assert got.shape[2] == 2 * a[phase]["left_video"].shape[2]
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=0,
                                   atol=STITCHED_TOL)
    assert mine.stitcher.last_method == ref.stitcher.last_method
