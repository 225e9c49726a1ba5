"""The one generator of the benchmark's traffic. A mix is a JSON file beside
this one (``<mix>.json``) whose ``kind`` names the loop that drives the
window (``benchmark/loops.py``) and whose other keys size the clips.

A clip is what the port's loader hands the model for one sample: GPS
fixes in meters at ``fps`` (``seq_len`` input and ``pred_len`` target
steps), the left, right and front camera frames of every step in the
loader's uint8 at ``frame_hw``, and ``gaze_len`` gaze samples over each
window. The tracks are smooth unicycle paths (heading and speed as
smoothed noise, as the port's synthetic data makes them); the gaze
follows the heading's change. Frames are uniform noise drawn on the
device. Everything follows from the seed alone.
"""

import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
VIEWS = ("left_video", "right_video", "front_video")


def load(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def _smooth_noise(rng, n, scale, smoothing=9):
    x = rng.normal(size=n + smoothing) * scale
    return np.convolve(x, np.ones(smoothing) / smoothing, mode="valid")[:n]


def trajectory(rng, length: int, fps: float) -> np.ndarray:
    """(length, 2) positions in meters."""
    heading = np.cumsum(_smooth_noise(rng, length, 0.15)) + rng.uniform(0, 2 * np.pi)
    speed = np.clip(8.0 + np.cumsum(_smooth_noise(rng, length, 0.3)), 0.5, 30.0)
    velocity = np.stack([np.cos(heading), np.sin(heading)], axis=-1) * (speed / fps)[:, None]
    return rng.uniform(-1e4, 1e4, size=2) + np.cumsum(velocity, axis=0)


def gaze(rng, heading: np.ndarray, n: int) -> np.ndarray:
    """(n, 2) normalised gaze drawn toward the turn."""
    change = np.gradient(heading)
    idx = np.linspace(0, heading.shape[0] - 1, n).astype(int)
    return np.stack([0.5 + 2.0 * change[idx] + rng.normal(0, 0.05, n),
                     0.5 + rng.normal(0, 0.05, n)], axis=-1)


def clips(mix: dict, seed: int, n: int, seq_len: int, pred_len: int, device) -> tuple:
    """``n`` clips as (input, target) dicts of tensors with a leading batch
    axis of ``n``: gps f32 on ``device``, frames uint8 on ``device``, gaze
    f32 on ``device``."""
    rng = np.random.default_rng(seed)
    length, fps = seq_len + pred_len, mix["fps"]
    tracks = np.stack([trajectory(rng, length, fps) for _ in range(n)]).astype(np.float32)
    vel = np.diff(tracks, axis=1, prepend=tracks[:, :1])
    heading = np.arctan2(vel[..., 1], vel[..., 0])
    looks = [np.stack([gaze(rng, h[a:b], mix["gaze_len"]) for h in heading]).astype(np.float32)
             for a, b in ((0, seq_len), (seq_len, length))]
    gen = torch.Generator(device=device).manual_seed(seed)
    inp, tgt = {}, {}
    for view in VIEWS:
        h, w = mix["frame_hw"][view]
        frames = torch.randint(0, 256, (n, length, h, w, 3), generator=gen, device=device,
                               dtype=torch.uint8)
        inp[view], tgt[view] = frames[:, :seq_len], frames[:, seq_len:]
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    inp["gps"], tgt["gps"] = as_t(tracks[:, :seq_len]), as_t(tracks[:, seq_len:])
    inp["gaze"], tgt["gaze"] = as_t(looks[0]), as_t(looks[1])
    return inp, tgt


def rows(batch: dict, start: int, stop: int) -> dict:
    """Clips ``start:stop`` of a dict of tensors, each contiguous."""
    return {k: v[start:stop].contiguous() for k, v in batch.items()}
