"""Frame conversion and conditioning (counterpart of
``routeformer_tpu/ops/image.py``): ``to_float16`` and ``dequantize_videos``
on the card; the backbones' shared input conditioning (pad to square,
resize to the native size, normalise); and the dataset's host
preprocessing in numpy, with no ``cv2``.

The host ops are the JAX package's ``undistort_video_numpy`` and
``resize_video_numpy``, which call ``cv2.remap`` and ``cv2.resize``
(INTER_LINEAR) on float32 frames and truncate back to uint8, computed as
the reference's cv2 (5.0) computes them, bit for bit: the remap samples at
the exact float32 source coordinate, reading 0 outside the image
(``BORDER_CONSTANT``); the resize takes half-pixel centres with its
coefficients in float64 rounded to float32, clamped at the edges, a
horizontal then a vertical pass; each interpolation is a lerp
``fma(t, b - a, a)`` with one rounding (``_fma32``). Each camera's remap
table and each resize's coefficient table is built once and cached by
(K, D, h, w) or (h, w, out), so a frame costs one uint8 gather and three
(remap) or two (resize) lerps.
"""

import threading
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_float16(frames: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float16 [0, 1]: divide in f32, round once.

    Bit-exact with the JAX package for all 256 values.
    """
    return (frames.float() / 255.0).to(torch.float16)


def dequantize_videos(batch: dict) -> dict:
    """uint8 ``*video*`` entries -> float16 [0, 1]; everything else as is."""
    return {
        k: (
            dequantize_videos(v)
            if isinstance(v, dict)
            else to_float16(v)
            if "video" in k and getattr(v, "dtype", None) == torch.uint8
            else v
        )
        for k, v in batch.items()
    }


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` on (N, H, W, C): half-pixel
    centres, antialiased when downsampling; computed in f32."""
    x = images.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).to(images.dtype)


def condition_frames(images: torch.Tensor, size: int, mean=IMAGENET_MEAN,
                     std=IMAGENET_STD, pad_to_square: bool = True) -> torch.Tensor:
    """The video backbones' input conditioning on (N, H, W, C) frames, as
    both JAX backbones do it: uint8 -> f16, pad to square (bottom/right),
    bilinear resize to ``size``, normalise in the frames' dtype."""
    if images.dtype == torch.uint8:
        images = to_float16(images)
    n, h, w, c = images.shape
    if pad_to_square and h != w:
        side = max(h, w)
        images = F.pad(images, (0, 0, 0, side - w, 0, side - h))
    if images.shape[1] != size or images.shape[2] != size:
        images = resize_bilinear(images, size)
    mean = torch.tensor(mean, dtype=images.dtype, device=images.device)
    std = torch.tensor(std, dtype=images.dtype, device=images.device)
    return (images - mean) / std


# --------------------------------------------------------------------- #
# Host preprocessing (numpy): undistort, crop, resize
# --------------------------------------------------------------------- #

_tables_lock = threading.Lock()
_remap_tables: dict = {}
_resize_tables: dict = {}


def _fma32(t: np.ndarray, d: np.ndarray, a: np.ndarray) -> np.ndarray:
    """float32 ``t * d + a`` with one rounding, as a fused multiply-add
    gives it, for float32-valued operands of any float dtype: the product
    and the sum are exact in float64 for these (float32 fractions, pixel
    values below 2^9)."""
    prod = np.multiply(t, d, dtype=np.float64)
    prod += a
    return prod.astype(np.float32)


def undistort_grid(K, D, h: int, w: int) -> np.ndarray:
    """Source-pixel sampling grid for undistortion, shape (h, w, 2) [x, y]:
    the forward distortion of the ideal grid, as cv2's
    ``initUndistortRectifyMap`` builds it."""
    K = np.asarray(K, dtype=np.float64).reshape(3, 3)
    D = np.asarray(D, dtype=np.float64).reshape(-1)
    d = np.zeros(5)
    d[: D.size] = D
    k1, k2, p1, p2, k3 = d[:5]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    x, y = np.meshgrid((np.arange(w) - cx) / fx, (np.arange(h) - cy) / fy)
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd * fx + cx, yd * fy + cy], axis=-1)


class RemapTable:
    """``cv2.remap(INTER_LINEAR, BORDER_CONSTANT)`` of (h, w) frames at a
    float32 map: per output pixel, the four taps' flat source indices
    (``h * w``, a zero pixel appended to the frame, for a tap outside the
    image) and the float32 fractions of the coordinate."""

    def __init__(self, map_x: np.ndarray, map_y: np.ndarray, src_hw: Tuple[int, int]):
        h, w = src_hw
        map_x = map_x.astype(np.float32)
        map_y = map_y.astype(np.float32)
        x0 = np.floor(map_x)
        y0 = np.floor(map_y)
        self.ax = (map_x - x0)[..., None].astype(np.float64)
        self.ay = (map_y - y0)[..., None].astype(np.float64)
        x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
        self.index = np.empty((4,) + map_x.shape, np.int64)
        for t, (yy, xx) in enumerate(((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1))):
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            self.index[t] = np.where(inside, yy * w + xx, h * w)
        self.shape = map_x.shape
        self.src_hw = (h, w)

    def apply(self, frames: np.ndarray, cols: slice = slice(None)) -> np.ndarray:
        """(N, h, w, C) frames -> (N, *shape[:2][cols], C), cast to the
        frames' dtype (truncation for uint8, as the reference's
        ``astype``); ``cols`` keeps a range of output columns (a crop after
        the remap, computed only where it is kept)."""
        n, h, w, c = frames.shape
        if (h, w) != self.src_hw:
            raise ValueError(f"remap table for {self.src_hw}, frames are {(h, w)}")
        index = self.index[:, :, cols]
        ax, ay = self.ax[:, cols], self.ay[:, cols]
        out = np.empty((n,) + index.shape[1:] + (c,), frames.dtype)
        flat = np.zeros((h * w + 1, c), np.float64)
        for i in range(n):
            flat[:-1] = frames[i].reshape(h * w, c)
            p00, p01, p10, p11 = (np.take(flat, index[t], axis=0) for t in range(4))
            top = _fma32(ax, p01 - p00, p00)
            bottom = _fma32(ax, p11 - p10, p10)
            out[i] = _fma32(ay, bottom - top, top)
        return out


def remap_table(K, D, h: int, w: int) -> RemapTable:
    """The cached undistortion table of a camera at (h, w), keyed by the
    calibration's bytes (two calibrations never share a table)."""
    key = (np.asarray(K, np.float64).tobytes(), np.asarray(D, np.float64).tobytes(), h, w)
    with _tables_lock:
        table = _remap_tables.get(key)
    if table is None:
        grid = np.asarray(undistort_grid(K, D, h, w), dtype=np.float32)
        table = RemapTable(grid[..., 0], grid[..., 1], (h, w))
        with _tables_lock:
            table = _remap_tables.setdefault(key, table)
    return table


def undistort_video_numpy(video: np.ndarray, K, D) -> np.ndarray:
    """Undistort a frame batch (N, H, W, C) on the host, as the JAX
    package's ``undistort_video_numpy`` (``cv2.remap`` in float32)."""
    return remap_table(K, D, video.shape[1], video.shape[2]).apply(video)


def undistort_image_numpy(img: np.ndarray, K, D) -> np.ndarray:
    """Single-image undistort, as the JAX package's ``undistort_image_numpy``
    computes it (``ops/image.remap``): a float32 bilinear gather at the
    exact grid, clamped to the border, cast back to the image's dtype."""
    h, w = img.shape[:2]
    grid = np.asarray(undistort_grid(K, D, h, w), dtype=np.float32)
    gx, gy = grid[..., 0], grid[..., 1]
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    wx = (gx - x0)[..., None]
    wy = (gy - y0)[..., None]
    x0c, x1c = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    y0c, y1c = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    f = img.astype(np.float32)
    top = f[y0c, x0c] * (1 - wx) + f[y0c, x1c] * wx
    bot = f[y1c, x0c] * (1 - wx) + f[y1c, x1c] * wx
    return (top * (1 - wy) + bot * wy).astype(img.dtype)


def crop_horizontal(frames, start: float = 0.3, end: float = 0.7):
    """The reference's 30%-70% width crop (dataset.py:1324-1338) of
    (..., H, W, C) frames: a view."""
    w = frames.shape[-2]
    return frames[..., int(start * w): int(end * w), :]


def crop_columns(w: int, start: float = 0.3, end: float = 0.7) -> slice:
    """The columns ``crop_horizontal`` keeps of a width-``w`` frame."""
    return slice(int(start * w), int(end * w))


def _linear_coefficients(n_in: int, n_out: int):
    """cv2's INTER_LINEAR taps along one axis: first tap and float32
    fraction of each output position, from half-pixel centres in float64;
    a position before the first or past the last source pixel reads the
    edge pixel alone."""
    f = (np.arange(n_out) + 0.5) / (n_out / n_in) - 0.5
    s = np.floor(f)
    frac = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    edge = (s < 0) | (s >= n_in - 1)
    s = np.clip(s, 0, n_in - 1)
    return s, np.minimum(s + 1, n_in - 1), np.where(edge, np.float32(0), frac)


class ResizeTable:
    """``cv2.resize(INTER_LINEAR)`` of (h, w) frames to ``out_hw`` in
    float32: a horizontal lerp over the source rows the vertical pass
    reads, then a vertical lerp."""

    def __init__(self, src_hw: Tuple[int, int], out_hw: Tuple[int, int]):
        (h, w), (oh, ow) = src_hw, out_hw
        self.x0, self.x1, ax = _linear_coefficients(w, ow)
        self.ax = ax[:, None].astype(np.float64)
        y0, y1, ay = _linear_coefficients(h, oh)
        self.ay = ay[:, None, None].astype(np.float64)
        self.rows = np.unique(np.concatenate([y0, y1]))
        pos = np.searchsorted(self.rows, np.arange(h))
        self.r0, self.r1 = pos[y0], pos[y1]
        self.src_hw, self.out_hw = (h, w), (oh, ow)

    def apply(self, frames: np.ndarray) -> np.ndarray:
        n, h, w, c = frames.shape
        if (h, w) != self.src_hw:
            raise ValueError(f"resize table for {self.src_hw}, frames are {(h, w)}")
        out = np.empty((n,) + self.out_hw + (c,), frames.dtype)
        for i in range(n):
            src = frames[i, self.rows].astype(np.float64)
            left = src[:, self.x0]
            rows = _fma32(self.ax, src[:, self.x1] - left, left)
            top = rows[self.r0]
            out[i] = _fma32(self.ay, rows[self.r1] - top, top)
        return out


def resize_table(src_hw: Tuple[int, int], out_hw: Tuple[int, int]) -> ResizeTable:
    key = (tuple(src_hw), tuple(out_hw))
    with _tables_lock:
        table = _resize_tables.get(key)
    if table is None:
        table = ResizeTable(src_hw, out_hw)
        with _tables_lock:
            table = _resize_tables.setdefault(key, table)
    return table


def resize_video_numpy(video: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a frame batch (N, H, W, C) on the host, as the
    JAX package's ``resize_video_numpy`` (``cv2.resize`` in float32)."""
    return resize_table(video.shape[1:3], out_hw).apply(video)
