"""Gaze fixation detection and camera models (counterpart of
``routeformer_tpu/io/gaze.py``).

Capability parity with reference ``routeformer/io/gaze.py`` (a trimmed
pupil-labs vendoring): dispersion-based I-DT fixation detection with binary
search for the fixation end (``detect_fixations`` :74-176,
``vector_dispersion`` :48), and radial-distortion camera models
(``Radial_Dist_Camera`` :255, ``Dummy_Camera`` :377).

The camera math is implemented in numpy (Brown-Conrady radial-tangential
model with iterative inverse distortion) instead of cv2 calls — the same
model cv2.undistortPoints evaluates; cv2 remains only a test oracle.
"""

import enum
from collections import deque
from typing import Dict, Sequence, Tuple

import numpy as np
from scipy.spatial.distance import pdist

from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.gaze")


class FixationDetectionMethod(enum.Enum):
    GAZE_2D = "2d gaze"
    GAZE_3D = "3d gaze"


def vector_dispersion(vectors: np.ndarray) -> float:
    """Angular dispersion: arccos(1 - max cosine distance)
    (reference gaze.py:48-51)."""
    distances = pdist(vectors, metric="cosine")
    return float(np.arccos(1.0 - distances.max()))


# --------------------------------------------------------------------------- #
# Camera models
# --------------------------------------------------------------------------- #


class CameraModel:
    """Pinhole camera with Brown-Conrady radial-tangential distortion."""

    cam_type = "radial"

    def __init__(self, name: str, resolution: Tuple[int, int], K, D):
        self.name = name
        self.resolution = tuple(resolution)
        self.K = np.asarray(K, dtype=np.float64).reshape(3, 3)
        self.D = np.asarray(D, dtype=np.float64).reshape(-1)

    def __repr__(self):
        return (
            f"<{type(self).__name__} {self.name} @ "
            f"{self.resolution[0]}x{self.resolution[1]}>"
        )

    @property
    def focal_length(self) -> float:
        return (self.K[0, 0] + self.K[1, 1]) / 2

    # -- distortion model -------------------------------------------------- #

    def _dist_coeffs(self, use_distortion: bool) -> np.ndarray:
        if not use_distortion:
            return np.zeros(5)
        d = np.zeros(max(5, self.D.size))
        d[: self.D.size] = self.D
        return d

    def distort_normalized(self, xy: np.ndarray, use_distortion=True) -> np.ndarray:
        """Forward distortion on normalized image coords (N, 2)."""
        k1, k2, p1, p2, k3 = self._dist_coeffs(use_distortion)[:5]
        x, y = xy[:, 0], xy[:, 1]
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return np.stack([xd, yd], axis=-1)

    def undistort_normalized(
        self, xy: np.ndarray, use_distortion=True, iterations: int = 40
    ) -> np.ndarray:
        """Inverse distortion by fixed-point iteration (cv2.undistortPoints
        model)."""
        k1, k2, p1, p2, k3 = self._dist_coeffs(use_distortion)[:5]
        x0, y0 = xy[:, 0], xy[:, 1]
        x, y = x0.copy(), y0.copy()
        for _ in range(iterations):
            r2 = x * x + y * y
            radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            x = (x0 - dx) / radial
            y = (y0 - dy) / radial
        return np.stack([x, y], axis=-1)

    # -- public api (reference Radial_Dist_Camera) ------------------------- #

    def unprojectPoints(self, pts_2d, use_distortion=True, normalize=False):
        """Pixel points (N, 2) -> 3-D rays (N, 3) (reference gaze.py:275-306)."""
        pts = np.asarray(pts_2d, dtype=np.float64).reshape(-1, 2)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        norm = np.stack([(pts[:, 0] - cx) / fx, (pts[:, 1] - cy) / fy], axis=-1)
        und = self.undistort_normalized(norm, use_distortion)
        pts_3d = np.concatenate([und, np.ones((und.shape[0], 1))], axis=-1)
        if normalize:
            pts_3d /= np.linalg.norm(pts_3d, axis=1, keepdims=True)
        return pts_3d

    def projectPoints(self, object_points, rvec=None, tvec=None, use_distortion=True):
        """3-D points -> pixels (reference gaze.py:308-343)."""
        pts = np.asarray(object_points, dtype=np.float64).reshape(-1, 3)
        if rvec is not None:
            pts = pts @ _rodrigues(np.asarray(rvec).reshape(3)).T
        if tvec is not None:
            pts = pts + np.asarray(tvec).reshape(1, 3)
        xy = pts[:, :2] / pts[:, 2:3]
        xyd = self.distort_normalized(xy, use_distortion)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        return np.stack([xyd[:, 0] * fx + cx, xyd[:, 1] * fy + cy], axis=-1)

    def undistort_points_to_ideal_point_coordinates(self, points):
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 2)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        norm = np.stack([(pts[:, 0] - cx) / fx, (pts[:, 1] - cy) / fy], axis=-1)
        return self.undistort_normalized(norm)

    def undistort(self, img: np.ndarray) -> np.ndarray:
        """Undistort an image (``ops/image.undistort_image_numpy``: a
        bilinear gather clamped at the border)."""
        from routeformer_torch.ops.image import undistort_image_numpy

        return undistort_image_numpy(img, self.K, self.D)

    def solvePnP(
        self,
        uv3d,
        xy,
        flags=None,
        useExtrinsicGuess: bool = False,
        rvec=None,
        tvec=None,
    ):
        """Camera pose from 3D-2D correspondences (reference gaze.py:344-374,
        cv2.solvePnP SOLVEPNP_ITERATIVE semantics; ``flags`` accepted for
        signature parity and ignored — this numpy implementation always
        runs the iterative refinement).

        Initialization: DLT on undistorted ideal coordinates (homography
        decomposition when the 3D points are coplanar), or the caller's
        rvec/tvec under ``useExtrinsicGuess``. Refinement: damped
        Gauss-Newton (Levenberg-Marquardt) on the pixel reprojection
        residual through the full distortion model. Returns
        ``(retval, rvec (3,1), tvec (3,1))`` like cv2.
        """
        try:
            obj = np.reshape(np.asarray(uv3d, np.float64), (-1, 3))
        except ValueError:
            raise ValueError("uv3d is not 3d points")
        try:
            img = np.reshape(np.asarray(xy, np.float64), (-1, 2))
        except ValueError:
            raise ValueError("xy is not 2d points")
        if obj.shape[0] != img.shape[0]:
            raise ValueError("the number of 3d points and 2d points are not the same")
        if obj.shape[0] < 4:
            return False, np.zeros((3, 1)), np.zeros((3, 1))

        ideal = self.undistort_points_to_ideal_point_coordinates(img)

        if useExtrinsicGuess and rvec is not None and tvec is not None:
            r0 = np.asarray(rvec, np.float64).reshape(3)
            t0 = np.asarray(tvec, np.float64).reshape(3)
        else:
            init = _pnp_initialize(obj, ideal)
            if init is None:
                return False, np.zeros((3, 1)), np.zeros((3, 1))
            r0, t0 = init

        r, t, ok = _pnp_refine(
            obj, img,
            lambda pts, rv, tv: self.projectPoints(pts, rvec=rv, tvec=tv),
            r0, t0,
        )
        return ok, r.reshape(3, 1), t.reshape(3, 1)


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * (kx @ kx)


def _rodrigues_inv(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (inverse Rodrigues)."""
    cos_t = np.clip((np.trace(r) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    if abs(theta - np.pi) < 1e-6:
        # Near pi the skew part vanishes, so magnitudes come from the
        # symmetric part m = (R + I)/2 (axis axis^T at exactly pi) and the
        # RELATIVE signs from m's off-diagonal column of the largest
        # component (axis_i * axis_k = m[i, k]). The skew part, when it is
        # still nonzero, disambiguates the overall sign; at exactly pi both
        # signs are valid and + is returned.
        m = (r + np.eye(3)) / 2
        mags = np.sqrt(np.maximum(np.diag(m), 0))
        k = int(np.argmax(mags))
        axis = m[:, k] / max(mags[k], 1e-12)
        axis[k] = mags[k]
        skew_k = (r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1])[k]
        if skew_k < 0:
            axis = -axis
        return theta * axis / np.linalg.norm(axis)
    axis = np.array(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    ) / (2 * np.sin(theta))
    return theta * axis


def _nearest_rotation(m: np.ndarray) -> np.ndarray:
    u, _, vt = np.linalg.svd(m)
    r = u @ vt
    if np.linalg.det(r) < 0:
        r = u @ np.diag([1.0, 1.0, -1.0]) @ vt
    return r


def _pnp_initialize(obj: np.ndarray, ideal: np.ndarray):
    """Closed-form pose seed from undistorted ideal coords: planar points
    go through homography decomposition, general clouds through DLT."""
    centered = obj - obj.mean(axis=0)
    coplanar = np.linalg.matrix_rank(centered, tol=1e-9 * max(
        1.0, float(np.abs(centered).max())
    )) < 3

    if coplanar:
        # plane basis: express points as (u, v, 0)
        _, _, vt = np.linalg.svd(centered)
        basis = vt[:2]
        uv = centered @ basis.T
        h = _dlt_homography(uv, ideal)
        if h is None:
            return None
        h1, h2, h3 = h[:, 0], h[:, 1], h[:, 2]
        scale = (np.linalg.norm(h1) + np.linalg.norm(h2)) / 2
        if scale < 1e-12:
            return None
        h /= scale
        r_cols = _nearest_rotation(
            np.stack([h[:, 0], h[:, 1], np.cross(h[:, 0], h[:, 1])], axis=1)
        )
        t = h[:, 2]
        # plane frame -> world frame: X_cam = R_p (u,v,0) + t with
        # (u,v) = basis (X - mean) => R_world = R_p[:, :2] @ basis
        r_world = r_cols @ np.vstack([basis, np.cross(basis[0], basis[1])])
        t_world = t - r_world @ obj.mean(axis=0)
        if np.median((obj @ r_world.T + t_world)[:, 2]) < 0:
            # points behind the camera: flip the homography sign
            h = -h
            r_cols = _nearest_rotation(
                np.stack(
                    [h[:, 0], h[:, 1], np.cross(h[:, 0], h[:, 1])], axis=1
                )
            )
            r_world = r_cols @ np.vstack([basis, np.cross(basis[0], basis[1])])
            t_world = h[:, 2] - r_world @ obj.mean(axis=0)
        return _rodrigues_inv(r_world), t_world

    if obj.shape[0] < 6:
        return None
    # DLT for P = [R|t] (up to scale) from x ~ P X
    n = obj.shape[0]
    a = np.zeros((2 * n, 12))
    xh = np.concatenate([obj, np.ones((n, 1))], axis=1)
    a[0::2, 0:4] = xh
    a[0::2, 8:12] = -ideal[:, 0:1] * xh
    a[1::2, 4:8] = xh
    a[1::2, 8:12] = -ideal[:, 1:2] * xh
    _, _, vt = np.linalg.svd(a)
    p = vt[-1].reshape(3, 4)
    m = p[:, :3]
    scale = np.cbrt(np.linalg.det(m)) if np.linalg.det(m) != 0 else None
    if scale is None or abs(scale) < 1e-12:
        return None
    p /= scale
    r = _nearest_rotation(p[:, :3])
    t = p[:, 3]
    if np.median((obj @ r.T + t)[:, 2]) < 0:
        r = _nearest_rotation(-p[:, :3])
        t = -p[:, 3]
    return _rodrigues_inv(r), t


def _dlt_homography(uv: np.ndarray, ideal: np.ndarray):
    """Plane (u, v) -> ideal image homography via DLT."""
    n = uv.shape[0]
    if n < 4:
        return None
    a = np.zeros((2 * n, 9))
    uvh = np.concatenate([uv, np.ones((n, 1))], axis=1)
    a[0::2, 0:3] = uvh
    a[0::2, 6:9] = -ideal[:, 0:1] * uvh
    a[1::2, 3:6] = uvh
    a[1::2, 6:9] = -ideal[:, 1:2] * uvh
    _, s, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    return h / (np.sign(h[2, 2]) if h[2, 2] != 0 else 1.0)


def _pnp_refine(obj, img_pts, project, r0, t0, iters: int = 60):
    """Levenberg-Marquardt on the pixel reprojection residual with a
    forward-difference Jacobian over the 6 pose parameters."""
    params = np.concatenate([r0, t0]).astype(np.float64)

    def residual(p):
        return (project(obj, p[:3], p[3:]) - img_pts).ravel()

    lam = 1e-3
    r = residual(params)
    cost = float(r @ r)
    for _ in range(iters):
        jac = np.empty((r.size, 6))
        for j in range(6):
            dp = np.zeros(6)
            dp[j] = 1e-6 * max(1.0, abs(params[j]))
            jac[:, j] = (residual(params + dp) - r) / dp[j]
        jtj = jac.T @ jac
        jtr = jac.T @ r
        improved = False
        for _ in range(10):
            try:
                step = np.linalg.solve(jtj + lam * np.diag(np.diag(jtj)), -jtr)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            cand = params + step
            rc = residual(cand)
            cc = float(rc @ rc)
            if cc < cost:
                params, r, cost = cand, rc, cc
                lam = max(lam / 10, 1e-12)
                improved = True
                break
            lam *= 10
        if not improved or cost < 1e-16:
            break
    return params[:3], params[3:], bool(np.isfinite(cost))


class Radial_Dist_Camera(CameraModel):
    """Name-compatible alias (reference gaze.py:255)."""

    @staticmethod
    def _from_raw_intrinsics(cam_name, resolution, intrinsics: Dict):
        cam_type = intrinsics.get("cam_type", "dummy")
        if cam_type == "radial":
            return Radial_Dist_Camera(
                cam_name, resolution,
                intrinsics["camera_matrix"], intrinsics["dist_coefs"],
            )
        logger.warning("Unknown camera type %r; using dummy intrinsics", cam_type)
        return Dummy_Camera(cam_name, resolution)


class Dummy_Camera(Radial_Dist_Camera):
    """Idealized pinhole, no distortion (reference gaze.py:377-391)."""

    cam_type = "dummy"

    def __init__(self, name, resolution, K=None, D=None):
        camera_matrix = K or [
            [1000.0, 0.0, resolution[0] / 2.0],
            [0.0, 1000.0, resolution[1] / 2.0],
            [0.0, 0.0, 1.0],
        ]
        dist_coefs = D or [0.0, 0.0, 0.0, 0.0, 0.0]
        super().__init__(name, resolution, camera_matrix, dist_coefs)


# --------------------------------------------------------------------------- #
# Fixation detection (I-DT with binary search)
# --------------------------------------------------------------------------- #


def _resolve_intrinsics(capture: Dict) -> CameraModel:
    intr = capture["intrinsics"]
    if isinstance(intr, CameraModel):
        return intr
    # The reference hardcodes the "(1088, 1080)" resolution key
    # (gaze.py:95-97).
    for key in ("(1088, 1080)",):
        if isinstance(intr, dict) and key in intr:
            return Radial_Dist_Camera._from_raw_intrinsics(
                "dummy", capture["frame_size"], intr[key]
            )
    if isinstance(intr, dict) and "cam_type" in intr:
        return Radial_Dist_Camera._from_raw_intrinsics(
            "dummy", capture["frame_size"], intr
        )
    return Dummy_Camera("dummy", capture["frame_size"])


def gaze_dispersion(
    capture: Dict, gaze_subset: Sequence, method=FixationDetectionMethod.GAZE_2D
) -> float:
    """Angular dispersion of a gaze subset (reference gaze.py:54-71)."""
    if method is FixationDetectionMethod.GAZE_3D:
        vectors = np.array([gp["gaze_point_3d"] for _, gp in gaze_subset])
    elif method is FixationDetectionMethod.GAZE_2D:
        precomputed = capture.get("_unprojected")
        if precomputed is not None:
            # detect_fixations unprojects every point ONCE up front;
            # re-unprojecting each sliding-window slice (the reference's
            # structure) costs 40 fixed-point iterations per call and
            # dominated dataset init. Identical math: unprojection is
            # per-point.
            vectors = np.array(
                [precomputed[idx] for idx, _ in gaze_subset]
            )
        else:
            locations = np.array(
                [gp["norm_pos"] for _, gp in gaze_subset], dtype=np.float64
            )
            width, height = capture["frame_size"]
            locations[:, 0] *= width
            locations[:, 1] = (1.0 - locations[:, 1]) * height
            vectors = capture["_camera"].unprojectPoints(locations)
    else:
        raise ValueError(f"Unknown method '{method}'")
    return vector_dispersion(vectors)


def detect_fixations(
    capture: Dict,
    gaze_data: Sequence,
    max_dispersion: float = np.deg2rad(1.50),
    min_duration: float = 80 / 1000,
    max_duration: float = 1000 / 1000,
    min_data_confidence: float = 0.6,
):
    """Dispersion-based fixation detection (reference gaze.py:74-176).

    Sliding window grows until ``min_duration``; if its angular dispersion
    stays below ``max_dispersion`` the window is extended up to
    ``max_duration`` and the exact fixation end is found by binary search.
    Returns a boolean array marking fixation samples (or the reference's
    failure tuple when no confident data exists).
    """
    capture = dict(capture)
    capture["_camera"] = _resolve_intrinsics(capture)

    indexed = [(idx, datum) for idx, datum in enumerate(gaze_data)]
    is_fixation = np.zeros(len(indexed), dtype=bool)
    filtered = [
        (idx, d) for idx, d in indexed if d["confidence"] > min_data_confidence
    ]
    if not filtered:
        logger.warning("No data available to find fixations")
        return "Fixation detection failed", ()

    # Unproject all confident points in one batched call (see
    # gaze_dispersion: per-window re-unprojection dominated dataset init).
    locations = np.array(
        [d["norm_pos"] for _, d in filtered], dtype=np.float64
    )
    width, height = capture["frame_size"]
    locations[:, 0] *= width
    locations[:, 1] = (1.0 - locations[:, 1]) * height
    all_vectors = capture["_camera"].unprojectPoints(locations)
    capture["_unprojected"] = {
        idx: all_vectors[i] for i, (idx, _) in enumerate(filtered)
    }

    working: deque = deque()
    remaining: deque = deque(filtered)

    while remaining:
        if (
            len(working) < 2
            or (working[-1][1]["timestamp"] - working[0][1]["timestamp"])
            < min_duration
        ):
            working.append(remaining.popleft())
            continue

        if gaze_dispersion(capture, working) > max_dispersion:
            working.popleft()
            continue

        left_idx = len(working)
        # extend to the maximum duration
        while remaining:
            if (
                remaining[0][1]["timestamp"]
                > working[0][1]["timestamp"] + max_duration
            ):
                break
            working.append(remaining.popleft())

        if gaze_dispersion(capture, working) <= max_dispersion:
            for idx, _ in working:
                is_fixation[idx] = True
            working.clear()
            continue

        slicable = list(working)
        right_idx = len(working)
        while left_idx < right_idx - 1:
            middle_idx = (left_idx + right_idx) // 2
            if gaze_dispersion(capture, slicable[: middle_idx + 1]) <= max_dispersion:
                left_idx = middle_idx
            else:
                right_idx = middle_idx

        final_base = slicable[:left_idx]
        put_back = slicable[left_idx:]
        for idx, _ in final_base:
            is_fixation[idx] = True
        working.clear()
        remaining.extendleft(reversed(put_back))

    logger.info(
        "Found %d fixations out of %d samples", int(is_fixation.sum()), len(is_fixation)
    )
    return is_fixation
