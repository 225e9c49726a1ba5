"""Synthetic driving batches (the port's numpy copy of
``routeformer_tpu/io/synthetic.py::synthetic_batch``, without the ``pci``
key): smooth unicycle GPS tracks in meters, gradient frames whose phase
follows the future heading change, and gaze biased toward the turn.

``synthetic_batch_numpy`` returns ``{"train": ..., "target": ...}`` numpy
arrays (the same values the JAX package makes from the same seed);
``synthetic_batch`` returns them as tensors on a device (CUDA by default).
"""

from typing import Tuple

import numpy as np
import torch

from routeformer_torch.utils.device import DeviceLike, resolve_device


def _smooth_noise(rng, n, scale, smoothing=9):
    x = rng.normal(size=n + smoothing) * scale
    return np.convolve(x, np.ones(smoothing) / smoothing, mode="valid")[:n]


def synthetic_trajectory(rng, total_len, fps=5.0, base_speed=8.0, turn_scale=0.15):
    heading = np.cumsum(_smooth_noise(rng, total_len, turn_scale))
    heading += rng.uniform(0, 2 * np.pi)
    speed = np.clip(
        base_speed + np.cumsum(_smooth_noise(rng, total_len, 0.3)), 0.5, 30.0
    )
    velocity = np.stack([np.cos(heading), np.sin(heading)], axis=-1) * (speed / fps)[:, None]
    origin = rng.uniform(-1e4, 1e4, size=2)
    return origin + np.cumsum(velocity, axis=0)


def _heading_frames(heading, h, w, phase_gain=4.0):
    t = heading.shape[0]
    phase = (np.gradient(heading) * phase_gain)[:, None, None]
    xs = np.linspace(0, 2 * np.pi, w)[None, None, :]
    ys = np.linspace(0, 2 * np.pi, h)[None, :, None]
    r = 0.5 + 0.5 * np.sin(xs + phase)
    g = 0.5 + 0.5 * np.cos(ys + phase * 2.0)
    b = np.broadcast_to(0.5 + 0.4 * np.sin(phase), (t, h, w))
    frames = np.stack(
        [np.broadcast_to(r, (t, h, w)), np.broadcast_to(g, (t, h, w)), b], axis=-1
    )
    return frames.astype(np.float32)


def synthetic_batch_numpy(seed: int, batch_size: int, seq_len: int = 40,
                          pred_len: int = 30, fps: float = 5.0,
                          with_video: bool = False, with_gaze: bool = False,
                          frame_hw: Tuple[int, int] = (24, 32),
                          gaze_len: int = 200, dtype=np.float32) -> dict:
    rng = np.random.default_rng(seed)
    h, w = frame_hw
    gps = np.stack(
        [synthetic_trajectory(rng, seq_len + pred_len, fps=fps)
         for _ in range(batch_size)]
    ).astype(dtype)
    train = {"gps": gps[:, :seq_len]}
    target = {"gps": gps[:, seq_len:]}
    if with_video or with_gaze:
        vel = np.diff(gps, axis=1, prepend=gps[:, :1])
        heading = np.arctan2(vel[..., 1], vel[..., 0])
    if with_video:
        frames = np.stack([_heading_frames(heading[i], h, w) for i in range(batch_size)])
        right = np.roll(frames, shift=3, axis=3)
        train["left_video"], target["left_video"] = frames[:, :seq_len], frames[:, seq_len:]
        train["right_video"], target["right_video"] = right[:, :seq_len], right[:, seq_len:]
    if with_gaze:
        front = np.stack(
            [_heading_frames(heading[i], h, w, phase_gain=2.0) for i in range(batch_size)]
        )
        train["front_video"], target["front_video"] = front[:, :seq_len], front[:, seq_len:]
        dh = np.gradient(heading[:, :seq_len], axis=1)
        idx = np.linspace(0, seq_len - 1, gaze_len).astype(int)
        gaze_x = 0.5 + 2.0 * dh[:, idx] + rng.normal(0, 0.05, (batch_size, gaze_len))
        gaze_y = 0.5 + rng.normal(0, 0.05, (batch_size, gaze_len))
        train["gaze"] = np.stack([gaze_x, gaze_y], axis=-1).astype(dtype)
        tidx = np.linspace(0, pred_len - 1, gaze_len).astype(int)
        dh_t = np.gradient(heading[:, seq_len:], axis=1)
        target["gaze"] = np.stack(
            [0.5 + 2.0 * dh_t[:, tidx] + rng.normal(0, 0.05, (batch_size, gaze_len)),
             0.5 + rng.normal(0, 0.05, (batch_size, gaze_len))],
            axis=-1,
        ).astype(dtype)
    return {"train": train, "target": target}


def synthetic_batch(seed: int, batch_size: int, device: DeviceLike = None,
                    **kwargs) -> dict:
    """``synthetic_batch_numpy`` as tensors on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    batch = synthetic_batch_numpy(seed, batch_size, **kwargs)
    return {
        split: {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in part.items()}
        for split, part in batch.items()
    }
