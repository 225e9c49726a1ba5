"""Gaze heatmap overlays (counterpart of
``routeformer_tpu/visualize/gaze.py``).

``overlay_heatmap_on_frame`` splats normalised gaze points into a Gaussian
heatmap (``ops.heatmap.rasterize_gaze_heatmap``, on the card unless the
caller passes ``device="cpu"``) and blends a jet-coloured copy onto the
frame where the heatmap exceeds 0.2; the ramp and the blend are numpy on
the host, as in the JAX package.
"""

import numpy as np

from routeformer_torch.ops.heatmap import rasterize_gaze_heatmap
from routeformer_torch.utils.device import DeviceLike


def _jet(values: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> BGR uint8 (the cv2 convention), a jet ramp."""
    v = np.clip(values, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * v - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * v - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * v - 1), 0, 1)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def overlay_heatmap_on_frame(frame: np.ndarray, gaze_points, sigma: float = 10.0,
                             device: DeviceLike = None) -> np.ndarray:
    """``frame``: (H, W, 3) BGR uint8; ``gaze_points``: (N, 2) normalised
    (x from the left, y from the bottom). Returns the frame with the
    heatmap blended in 0.6/0.4 where it exceeds 0.2."""
    frame = np.asarray(frame)
    h, w = frame.shape[:2]
    pts = np.asarray(gaze_points, dtype=np.float64).reshape(-1, 2)
    px = pts[:, 0] * w
    py = (1.0 - pts[:, 1]) * h
    heat = rasterize_gaze_heatmap(np.stack([px, py], axis=-1)[None], height=h, width=w,
                                  sigma=sigma, device=device)[0].cpu().numpy()
    colored = _jet(heat)
    overlaid = frame.astype(np.float32) * 0.6 + colored.astype(np.float32) * 0.4
    overlaid = overlaid.astype(np.uint8)
    mask = heat[..., None] > 0.2
    return np.where(mask, overlaid, frame)
