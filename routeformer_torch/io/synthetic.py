"""Synthetic driving batches (the port's numpy copy of
``routeformer_tpu/io/synthetic.py``): smooth unicycle GPS tracks in meters,
gradient frames whose phase follows the future heading change, gaze biased
toward the turn, and each sample's PCI.

``synthetic_batch_numpy`` returns ``{"train": ..., "target": ..., "pci":
...}`` numpy arrays (the same values the JAX package makes from the same
seed; ``pci`` to f32 rounding); ``synthetic_batch`` returns them as tensors
on a device (CUDA by default); ``SyntheticDataset`` indexes numpy batches.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from routeformer_torch.score.pci import estimate_pci_batch
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
    pci = estimate_pci_batch(train["gps"].astype(np.float64),
                             target["gps"].astype(np.float64),
                             curve_type="linear", frequency=fps)
    return {"train": train, "target": target, "pci": pci.astype(np.float32)}


def _to_tensors(value, dev):
    if isinstance(value, dict):
        return {k: _to_tensors(v, dev) for k, v in value.items()}
    return torch.from_numpy(np.ascontiguousarray(value)).to(dev)


def synthetic_batch(seed: int, batch_size: int, device: DeviceLike = None,
                    **kwargs) -> dict:
    """``synthetic_batch_numpy`` as tensors on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    return _to_tensors(synthetic_batch_numpy(seed, batch_size, **kwargs), dev)


@dataclass
class SyntheticDataset:
    """Indexable dataset of synthetic numpy batches (one batch per index)."""

    n_batches: int
    batch_size: int
    seq_len: int = 40
    pred_len: int = 30
    fps: float = 5.0
    with_video: bool = False
    with_gaze: bool = False
    frame_hw: Tuple[int, int] = (24, 32)
    gaze_len: int = 200
    seed: int = 0

    def __len__(self) -> int:
        return self.n_batches

    def __getitem__(self, idx: int) -> dict:
        if not 0 <= idx < self.n_batches:
            raise IndexError(idx)
        return synthetic_batch_numpy(
            seed=self.seed * 100003 + idx, batch_size=self.batch_size,
            seq_len=self.seq_len, pred_len=self.pred_len, fps=self.fps,
            with_video=self.with_video, with_gaze=self.with_gaze,
            frame_hw=self.frame_hw, gaze_len=self.gaze_len,
        )
