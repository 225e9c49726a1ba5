"""Panorama stitching of left/right views (counterpart of
``routeformer_tpu/io/stitcher.py``).

``ImageStitcher.stitch_pair`` estimates a homography between a left/right
frame pair and reuses it for later frames; the right frame is warped onto
a double-width canvas and blended with the left. Estimation is the JAX
package's, through cv2 as there: ORB features with a ratio test and a
MAGSAC homography, a dense NCC patch-match fallback for low-texture
frames, an explicit gate for frames with no structure, and the per-frame
degradation policy (reuse the cached homography, else side-by-side, with
a retry every ``RETRY_PERIOD`` frames). ``ImageStitcher`` raises
``ImportError`` naming cv2 when it is built where cv2 cannot be imported.

The warp and the blend run on an explicit device (the card unless given
``device="cpu"``): the inverse-homography grid in float64 on the host,
cached per homography and frame size, then ``ops/image.remap`` and the
feathered blend as torch ops; the canvas comes back as float32 numpy.
"""

import threading
from typing import Optional

import numpy as np
import torch

from routeformer_torch.ops.image import remap
from routeformer_torch.utils.device import DeviceLike, resolve_device
from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.stitcher")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "io/stitcher.py: homography estimation (ORB, MAGSAC, NCC template matching) "
            "needs cv2, which cannot be imported here") from e
    return cv2


def _cv2_error():
    """``cv2.error``: what cv2 raises on frames it cannot take (a 1 x 1
    frame in ORB, an empty one in ``cvtColor``)."""
    return _cv2().error


class RobustHomography:
    """MAGSAC homography from point correspondences."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold

    def estimate(self, keypoints1: np.ndarray, keypoints2: np.ndarray):
        cv2 = _cv2()
        if len(keypoints1) < 4:
            raise ValueError("need at least 4 correspondences for a homography")
        method = getattr(cv2, "USAC_MAGSAC", cv2.RANSAC)
        H, mask = cv2.findHomography(np.asarray(keypoints1, dtype=np.float64),
                                     np.asarray(keypoints2, dtype=np.float64), method,
                                     self.threshold)
        if H is None:
            raise ValueError("homography estimation failed")
        return H, mask


def _match_orb(img1: np.ndarray, img2: np.ndarray, n_features: int = 2000):
    """ORB and ratio-test correspondences."""
    cv2 = _cv2()

    def to_u8_gray(img):
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        return img

    orb = cv2.ORB_create(nfeatures=n_features)
    k1, d1 = orb.detectAndCompute(to_u8_gray(img1), None)
    k2, d2 = orb.detectAndCompute(to_u8_gray(img2), None)
    if d1 is None or d2 is None:
        return np.zeros((0, 2)), np.zeros((0, 2))
    matches = cv2.BFMatcher(cv2.NORM_HAMMING).knnMatch(d1, d2, k=2)
    good = [m for m, n in (p for p in matches if len(p) == 2) if m.distance < 0.75 * n.distance]
    pts1 = np.array([k1[m.queryIdx].pt for m in good])
    pts2 = np.array([k2[m.trainIdx].pt for m in good])
    return pts1, pts2


def _to_gray_f32(img: np.ndarray) -> np.ndarray:
    cv2 = _cv2()
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    return img


def _highpass(img: np.ndarray, sigma: float = 12.0) -> np.ndarray:
    """Remove the smooth shading, which carries no alignment information,
    so that NCC locks onto the weak structure left."""
    return img - _cv2().GaussianBlur(img, (0, 0), sigma)


def _match_patches(gl: np.ndarray, gr: np.ndarray, H: Optional[np.ndarray], patch: int,
                   search: int, min_score: float, step: int = 28):
    """Dense NCC template correspondences between high-passed grays: a grid
    of ``patch``-sized left patches located (``TM_CCOEFF_NORMED``) in the
    right image, pre-warped by ``H`` when given, within a ``search``
    margin. Returns (left points, points in the warped-right frame)."""
    cv2 = _cv2()
    h_px, w_px = gl.shape
    grw = gr if H is None else cv2.warpPerspective(gr, H.astype(np.float64), (w_px, h_px))
    pts_l, pts_w = [], []
    half = patch // 2
    for cy in range(half + 8, h_px - half - 8, step):
        for cx in range(half + 8, w_px - half - 8, step):
            tmpl = gl[cy - half: cy + half, cx - half: cx + half]
            if tmpl.std() < 1e-4:
                continue
            y0, y1 = max(0, cy - half - search), min(h_px, cy + half + search)
            x0, x1 = max(0, cx - half - search), min(w_px, cx + half + search)
            res = cv2.matchTemplate(grw[y0:y1, x0:x1], tmpl, cv2.TM_CCOEFF_NORMED)
            _, mx, _, loc = cv2.minMaxLoc(res)
            if mx < min_score:
                continue
            pts_l.append((cx, cy))
            pts_w.append((x0 + loc[0] + half, y0 + loc[1] + half))
    return np.asarray(pts_l, np.float64), np.asarray(pts_w, np.float64)


# (patch px, search px, min NCC score, MAGSAC threshold) per round: a
# small-patch wide-search bootstrap, then two large-patch narrow-search
# refinements against the pre-warped right frame.
_DENSE_ROUNDS = ((24, 70, 0.40, 3.0), (40, 16, 0.55, 1.0), (40, 8, 0.55, 1.0))
_DENSE_MIN_MATCHES = 8


def _dense_match_homography(left: np.ndarray, right: np.ndarray):
    """The dense fallback for frames where sparse features collapse:
    iterated NCC patch correspondences and MAGSAC. Raises ``ValueError``
    (the explicit gate) when the frames carry too little structure."""
    gl = _highpass(_to_gray_f32(left))
    gr = _highpass(_to_gray_f32(right))
    H = None
    for rnd, (patch, search, score, thr) in enumerate(_DENSE_ROUNDS):
        pts_l, pts_w = _match_patches(gl, gr, H, patch=patch, search=search, min_score=score)
        if len(pts_l) < _DENSE_MIN_MATCHES:
            raise ValueError(
                f"dense fallback: only {len(pts_l)} patch matches in round {rnd} (needs "
                f"{_DENSE_MIN_MATCHES}) — frames carry too little structure to align")
        if H is None:
            pts_r = pts_w
        else:  # warped-right frame -> original right coordinates
            q = np.concatenate([pts_w, np.ones((len(pts_w), 1))], axis=1) @ np.linalg.inv(H).T
            pts_r = q[:, :2] / q[:, 2:3]
        H, mask = RobustHomography(threshold=thr).estimate(pts_r, pts_l)
    return H, int(mask.sum())


class ImageStitcher:
    """Stitch left/right frame sequences with a reused homography."""

    # Below these, sparse estimation is degraded and the dense fallback
    # takes over (textured pairs give >= 4x more).
    MIN_CORRESPONDENCES = 20
    MIN_INLIERS = 12

    # While degraded, re-estimate every Nth stitched frame rather than every
    # frame: the dense fallback costs ~100 ms a frame.
    RETRY_PERIOD = 25

    def __init__(self, threshold: float = 0.5, blend: str = "feather",
                 device: DeviceLike = None):
        _cv2()
        self.homography = RobustHomography(threshold)
        self.blend = blend
        self.device = resolve_device(device)
        self._cached_h: Optional[np.ndarray] = None
        # "orb" / "dense" / "orb-degraded" / "reuse-cached" / "side-by-side"
        self.last_method: Optional[str] = None
        self._degraded = False
        self._frames_since_retry = 0
        self._grid_key = None
        self._grid = self._in_bounds = None
        self._lock = threading.Lock()  # one sequence at a time: the state is per sequence

    def estimate(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        """Estimate (and cache) the right -> left-canvas homography: sparse
        ORB and MAGSAC first; under the degradation gate the dense
        fallback; ``ValueError`` when both fail."""
        pts_r, pts_l = _match_orb(right, left)
        H = None
        sparse_h = None
        if len(pts_r) >= 4:
            try:
                sparse_h, mask = self.homography.estimate(pts_r, pts_l)
                n_inliers = int(mask.sum()) if mask is not None else 0
                if len(pts_r) >= self.MIN_CORRESPONDENCES and n_inliers >= self.MIN_INLIERS:
                    H = sparse_h
                    self.last_method = "orb"
            except ValueError:
                sparse_h = None
        if H is None:
            logger.info("sparse matching degraded (%d correspondences); using the dense NCC "
                        "patch-match fallback", len(pts_r))
            try:
                H, _ = _dense_match_homography(left, right)
                self.last_method = "dense"
            except ValueError:
                if sparse_h is None:
                    raise
                # a degraded but usable sparse estimate (e.g. frames too small
                # for the dense patch grid)
                logger.warning("dense fallback gated too; keeping the degraded sparse "
                               "homography (%d correspondences)", len(pts_r))
                H = sparse_h
                self.last_method = "orb-degraded"
        self._cached_h = H
        self._degraded = False
        self._frames_since_retry = 0
        return H

    def _estimate_for_stitch(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        """The per-frame policy of the dataset path, which never raises: on
        a failure the cached homography, else side-by-side placement; either
        marks the stitcher degraded, retried every ``RETRY_PERIOD`` frames."""
        try:
            return self.estimate(left, right)
        except (ValueError, _cv2_error()) as e:
            self._degraded = True
            self._frames_since_retry = 0
            if self._cached_h is not None:
                logger.warning("homography estimation failed (%s); reusing the cached "
                               "homography from an earlier frame", e)
                self.last_method = "reuse-cached"
                return self._cached_h
            logger.warning("homography estimation failed with no cached estimate (%s); "
                           "degrading to side-by-side placement", e)
            h = np.eye(3)
            h[0, 2] = float(left.shape[1])
            self._cached_h = h
            self.last_method = "side-by-side"
            return h

    def _warp_grid(self, H: np.ndarray, h_px: int, w_px: int):
        """The canvas's source coordinates in ``right`` (float32, on the
        device) and the in-bounds mask, for ``H`` at this frame size."""
        key = (H.tobytes(), h_px, w_px)
        if key != self._grid_key:
            hinv = np.linalg.inv(H)
            ys, xs = np.mgrid[0:h_px, 0:2 * w_px].astype(np.float64)
            coords = np.stack([xs, ys, np.ones_like(xs)], axis=-1) @ hinv.T
            grid = coords[..., :2] / np.maximum(coords[..., 2:3], 1e-9)
            in_bounds = ((grid[..., 0] >= 0) & (grid[..., 0] < w_px)
                         & (grid[..., 1] >= 0) & (grid[..., 1] < h_px))[..., None]
            self._grid = torch.from_numpy(grid.astype(np.float32)).to(self.device)
            self._in_bounds = torch.from_numpy(in_bounds.astype(np.float32)).to(self.device)
            self._grid_key = key
        return self._grid, self._in_bounds

    def stitch_pair(self, left: np.ndarray, right: np.ndarray, reuse: bool = True) -> np.ndarray:
        """Stitch one left/right pair onto a double-width canvas. Never
        raises: estimation failures degrade as ``_estimate_for_stitch``."""
        h_px, w_px = left.shape[:2]
        if self._cached_h is None or not reuse:
            self._estimate_for_stitch(left, right)
        elif self._degraded:
            self._frames_since_retry += 1
            if self._frames_since_retry >= self.RETRY_PERIOD:
                self._estimate_for_stitch(left, right)
        grid, in_bounds = self._warp_grid(self._cached_h, h_px, w_px)

        right_t = torch.as_tensor(np.ascontiguousarray(right), dtype=torch.float32)
        warped = remap(right_t.to(self.device)[None], grid)[0] * in_bounds
        left_t = torch.as_tensor(np.ascontiguousarray(left), dtype=torch.float32)
        canvas = torch.zeros((h_px, 2 * w_px, left.shape[2]), dtype=torch.float32,
                             device=self.device)
        canvas[:, :w_px] = left_t.to(self.device)
        left_mask = torch.zeros((h_px, 2 * w_px, 1), dtype=torch.float32, device=self.device)
        left_mask[:, :w_px] = 1.0
        overlap = left_mask * in_bounds
        canvas = torch.where(overlap > 0, 0.5 * canvas + 0.5 * warped,
                             canvas + warped * (1 - left_mask))
        return canvas.cpu().numpy()

    def stitch_sequence(self, left_frames, right_frames) -> np.ndarray:
        """Stitch aligned sequences, estimating the homography on the first
        pair and reusing it."""
        with self._lock:
            out = [self.stitch_pair(lf, rf, reuse=i > 0)
                   for i, (lf, rf) in enumerate(zip(left_frames, right_frames))]
        return np.stack(out)
