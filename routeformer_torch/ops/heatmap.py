"""Gaze Gaussian heatmaps (counterpart of ``routeformer_tpu/ops/heatmap.py``).

``rasterize_gaze_heatmap`` splats a batch of gaze points into dense
heatmaps with the JAX package's arithmetic: separable f32 Gaussians over
``arange`` grids, contracted over the points in one batched product
(``bnh,bnw->bhw``) and max-normalised per item. It runs on the device of
its input; a numpy input goes to ``resolve_device(device)``, the card
unless the caller passes ``device="cpu"``.

A NaN point does not contribute ~0, whatever the JAX docstring says: its
Gaussian row is NaN, the contraction sums it into every pixel, and the
whole item comes back NaN (the other items are untouched). The port keeps
that arithmetic, NaN included. A point far outside the frame gives an
all-zero map (its Gaussians underflow and the peak is clamped to 1e-12).
"""

from typing import Optional

import numpy as np
import torch

from routeformer_torch.utils.device import DeviceLike, resolve_device


def _as_f32(x, device: DeviceLike) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.tensor(np.asarray(x, dtype=np.float32), device=resolve_device(device))


def rasterize_gaze_heatmap(points, height: int, width: int, sigma: float = 10.0,
                           weights=None, device: DeviceLike = None) -> torch.Tensor:
    """(B, N, 2) pixel coordinates (x, y) -> (B, height, width) f32
    heatmaps, each divided by ``max(peak, 1e-12)``. ``weights``: optional
    (B, N) per-point weights on the y factor (e.g. confidence)."""
    points = _as_f32(points, device)
    dev = points.device
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    ys = torch.arange(height, dtype=torch.float32, device=dev)
    dx = points[..., 0:1] - xs  # (B, N, W)
    dy = points[..., 1:2] - ys  # (B, N, H)
    gx = torch.exp(-0.5 * (dx / sigma) ** 2)
    gy = torch.exp(-0.5 * (dy / sigma) ** 2)
    if weights is not None:
        gy = gy * _as_f32(weights, dev)[..., None]
    heat = torch.bmm(gy.transpose(1, 2), gx)  # bnh,bnw->bhw
    peak = heat.amax(dim=(1, 2), keepdim=True)
    return heat / torch.clamp_min(peak, 1e-12)


def overlay_heatmap_on_frame(frame, heatmap, alpha: float = 0.5,
                             device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Blend a heatmap onto a frame with a red-yellow ramp where it exceeds
    1e-3. ``frame``: (H, W, 3) float in [0, 1]; ``heatmap``: (H, W) in [0,
    1] (numpy inputs go to ``heatmap``'s device, or ``resolve_device``)."""
    heatmap = _as_f32(heatmap, device)
    frame = _as_f32(frame, heatmap.device)
    h = torch.clamp(heatmap, 0.0, 1.0)
    colored = torch.stack([h, h * 0.6, torch.zeros_like(h)], dim=-1)
    mask = (h > 1e-3)[..., None] * alpha
    return frame * (1 - mask) + colored * mask
