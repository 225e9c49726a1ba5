"""Frame conversion and conditioning (counterpart of
``routeformer_tpu/ops/image.py``): ``to_float16`` and ``dequantize_videos``
on the card; the backbones' shared input conditioning (pad to square,
resize to the native size, normalise); the JAX package's device image ops
(``remap``, ``undistort_video``, ``resize_video``) as torch ops on the
frames' device; and the datasets' host preprocessing in numpy, with no
``cv2``.

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
(remap) or two (resize) lerps. ``AreaTable`` is DR(eye)VE's
``cv2.resize(INTER_AREA)`` on uint8 frames, also bit for bit: cv2's box sum
for integer factors, its area-weight tables with float32 accumulation
otherwise (the mode is chosen as cv2 chooses it).
"""

import math
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
    """``resize_video`` to (size, size), cast back to the images' dtype."""
    return resize_video(images, (size, size)).to(images.dtype)


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
    mean, std = _statistics(mean, std, images.dtype, images.device)
    return (images - mean) / std


_statistics_cache = {}  # (mean, std, dtype, device) -> the statistics' tensors


def _statistics(mean, std, dtype, device):
    """The ``(mean, std)`` tensors, copied to ``device`` once per key: a copy
    from the host waits for the stream, so none is left in the forward."""
    key = (tuple(mean), tuple(std), dtype, device)
    if key in _statistics_cache:
        return _statistics_cache[key]
    if torch.compiler.is_exporting():  # a graph value, never cached
        return tuple(torch.tensor(s, dtype=dtype, device=device) for s in (mean, std))
    with torch.inference_mode(False):  # kept for forwards under autograd too
        stats = tuple(torch.tensor(s, dtype=dtype, device=device) for s in (mean, std))
    _statistics_cache[key] = stats
    return stats


# --------------------------------------------------------------------- #
# Device image ops: remap, undistort, resize
# --------------------------------------------------------------------- #


def remap(frames: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``ops/image.remap`` of the JAX package: frames (N, H, W, C) sampled
    bilinearly at grid (H', W', 2) [x, y] source pixels, a coordinate
    outside the image clamped to the border; float32 on the frames'
    device."""
    frames = frames.float()
    grid = grid.to(device=frames.device, dtype=torch.float32)
    h, w = frames.shape[1:3]
    gx, gy = grid[..., 0], grid[..., 1]
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = (gx - x0)[..., None], (gy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x0c, x1c = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    top = frames[:, y0c, x0c] * (1 - wx) + frames[:, y0c, x1c] * wx
    bottom = frames[:, y1c, x0c] * (1 - wx) + frames[:, y1c, x1c] * wx
    return top * (1 - wy) + bottom * wy


def undistort_video(frames: torch.Tensor, K, D) -> torch.Tensor:
    """Undistort a frame batch (N, H, W, C) on its device."""
    h, w = int(frames.shape[1]), int(frames.shape[2])
    return remap(frames, torch.from_numpy(undistort_grid(K, D, h, w).astype(np.float32)))


def resize_video(frames: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` of a frame batch (N, H, W, C)
    to ``out_hw`` on its device: half-pixel centres, the triangle kernel
    widened by the factor where an axis shrinks (antialiased), f32."""
    x = frames.float().permute(0, 3, 1, 2)
    x = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return x.permute(0, 2, 3, 1)


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


def _area_table(n_in: int, n_out: int, scale: float):
    """cv2's ``computeResizeAreaTab`` along one axis as dense (P, n_out)
    source indices and float32 weights, each output's entries in cv2's
    order; an unused entry has weight 0 (adding 0 changes no sum)."""
    entries = [[] for _ in range(n_out)]
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(math.floor(f2), n_in - 1)
        s1 = min(math.ceil(f1), s2)
        if s1 - f1 > 1e-3:
            entries[d].append((s1 - 1, (s1 - f1) / cell))
        entries[d] += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            entries[d].append((s2, min(min(f2 - s2, 1.0), cell) / cell))
    p = max(len(e) for e in entries)
    index = np.zeros((p, n_out), np.int64)
    weight = np.zeros((p, n_out), np.float32)
    for d, e in enumerate(entries):
        for k, (s, a) in enumerate(e):
            index[k, d], weight[k, d] = s, a
    return index, weight


class AreaTable:
    """``cv2.resize(INTER_AREA)`` of uint8 (h, w) frames to ``out_hw``, as
    cv2 5.0 computes it. cv2 takes the factor ``1 / (out / in)`` per axis in
    float64; when both are integers it sums each box exactly (a factor of 2
    on both axes rounds ``(sum + 2) >> 2``, other factors
    ``rint(float32(sum) * float32(1 / area))``); otherwise it accumulates
    area weights in float32, a horizontal pass over each source row then a
    vertical one, each step ``acc + x * w`` with two roundings."""

    def __init__(self, src_hw: Tuple[int, int], out_hw: Tuple[int, int]):
        (h, w), (oh, ow) = src_hw, out_hw
        sx, sy = 1.0 / (ow / w), 1.0 / (oh / h)
        if sx < 1 or sy < 1:
            raise ValueError(f"INTER_AREA tables shrink; {src_hw} -> {out_hw} grows")
        ix, iy = int(round(sx)), int(round(sy))
        eps = np.finfo(np.float64).eps
        self.box = (ix, iy) if abs(sx - ix) < eps and abs(sy - iy) < eps else None
        if self.box is None:
            self.x_index, self.x_weight = _area_table(w, ow, sx)
            self.y_index, y_weight = _area_table(h, oh, sy)
            self.y_weight = y_weight[..., None, None]
        self.src_hw, self.out_hw = (h, w), (oh, ow)

    def apply(self, frames: np.ndarray) -> np.ndarray:
        """(N, h, w, C) uint8 -> (N, *out_hw, C) uint8."""
        n, h, w, c = frames.shape
        if (h, w) != self.src_hw:
            raise ValueError(f"area table for {self.src_hw}, frames are {(h, w)}")
        oh, ow = self.out_hw
        out = np.empty((n, oh, ow, c), np.uint8)
        for i in range(n):
            out[i] = self._box(frames[i]) if self.box is not None else self._areas(frames[i])
        return out

    def _box(self, frame: np.ndarray) -> np.ndarray:
        (bx, by), (oh, ow) = self.box, self.out_hw
        total = np.zeros((oh, ow, frame.shape[2]), np.int32)
        for dy in range(by):
            for dx in range(bx):
                total += frame[dy: oh * by: by, dx: ow * bx: bx]
        if self.box == (2, 2):
            return (total + 2) >> 2
        return np.rint(total.astype(np.float32) * np.float32(1.0 / (bx * by)))

    def _areas(self, frame: np.ndarray) -> np.ndarray:
        src = frame.astype(np.float32)
        rows = np.take(src, self.x_index[0], axis=1)
        rows *= self.x_weight[0][:, None]
        for k in range(1, len(self.x_index)):
            part = np.take(src, self.x_index[k], axis=1)
            part *= self.x_weight[k][:, None]
            rows += part
        acc = rows[self.y_index[0]]
        acc *= self.y_weight[0]
        for k in range(1, len(self.y_index)):
            part = rows[self.y_index[k]]
            part *= self.y_weight[k]
            acc += part
        return np.rint(np.clip(acc, 0, 255, out=acc), out=acc)


def area_table(src_hw: Tuple[int, int], out_hw: Tuple[int, int]) -> AreaTable:
    key = ("area", tuple(src_hw), tuple(out_hw))
    with _tables_lock:
        table = _resize_tables.get(key)
    if table is None:
        table = AreaTable(src_hw, out_hw)
        with _tables_lock:
            table = _resize_tables.setdefault(key, table)
    return table


def resize_area(frame: np.ndarray, scale: float) -> np.ndarray:
    """``cv2.resize(frame, (int(w * scale), int(h * scale)), INTER_AREA)``
    of one uint8 (h, w, C) frame, as the DR(eye)VE reader calls it."""
    h, w = frame.shape[:2]
    return area_table((h, w), (int(h * scale), int(w * scale))).apply(frame[None])[0]
