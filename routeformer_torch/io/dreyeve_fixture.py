"""DR(eye)VE sessions written from a seed, with no JAX, cv2 or pandas: test
and smoke support for the DR(eye)VE data path, not a user feature.

``build_dreyeve_fixture`` writes sessions in the layout that
``io/dataset_dreyeve.DreyeveDataset`` and the JAX package's reader both
read:

  root/dr(eye)ve_design.txt
  root/NN/video_garmin_frames/{:06d}.jpg, root/NN/video_etg_frames/{:06d}.jpg
  root/NN/video_garmin.avi, root/NN/video_etg.avi   (with ``avi=True``)
  root/NN/etg_samples.txt, root/NN/speed_course_coord.txt

The frame files hold 24-bit BMP content under their ``.jpg`` names: cv2
reads them by content, as the port does without cv2. The AVIs hold
uncompressed 24-bit ``BI_RGB`` frames (bottom-up unless ``avi_top_down``).
Frame ``i`` of a stream is a seeded uint8 noise image rolled ``i % W``
pixels along its width and ``i // W`` along its height, so distinct frames
stay distinct after any scaling and crop. The trajectory is a random walk
of the heading at 30 Hz plus ``turn`` radians of weave, so that windows
pass a PCI filter.

The logs carry the traps of the JAX dataset's pandas join: NaN tokens of
several spellings, NaN gaps inside the gaze X/Y and the GPS speed, course,
lat and lon, frames with one gaze reading, and (unless ``sparse``) NaN
X/Y and lat/lon at both ends and one duplicated GPS frame. With
``sparse=True`` only the frames a window reads are written (ids that are
multiples of ``30 / output_fps``) and nothing the join drops or repeats,
so the joined rows stay aligned with the frame ids.
"""

from pathlib import Path
from typing import Iterable, Tuple

import numpy as np

from routeformer_torch.io.frames import write_avi, write_bmp
from routeformer_torch.io.resample import inverse_gps_coordinates

FPS = 30
SCENES = ("Downtown", "Highway", "Countryside")
NAN_SPELLINGS = ("", "NaN", "nan", "NA", "N/A", "NULL", "None")


def trajectory(n: int, seed: int, turn: float, turn_period_s: float = 16.0):
    """(n, 2) web-mercator metres and the heading (radians) at 30 Hz."""
    rng = np.random.default_rng(seed)
    heading = np.cumsum(rng.normal(0, 0.01, n)) + rng.uniform(0, 2 * np.pi)
    heading += turn * np.sin(2 * np.pi * np.arange(n) / (FPS * turn_period_s))
    speed = 10.0 / FPS
    xy = np.array([1.0e6 + 1.0e5 * seed, 5.0e6]) + np.cumsum(
        np.stack([np.cos(heading), np.sin(heading)], -1) * speed, axis=0)
    return xy, heading


def _frames(base: np.ndarray, ids: Iterable[int]):
    w = base.shape[1]
    for i in ids:
        yield np.roll(base, (i // w, i % w), axis=(0, 1))


def build_session(root: Path, session_id: int, duration_s: float = 20.0,
                  garmin_hw: Tuple[int, int] = (36, 64), etg_hw: Tuple[int, int] = (36, 64),
                  seed: int = 0, turn: float = 1.0, sparse: bool = False,
                  output_fps: int = 5, avi: bool = False, avi_top_down: bool = False) -> Path:
    """One session ``NN`` under ``root``; returns its directory."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * FPS)
    base = Path(root) / f"{session_id:02d}"
    garmin = rng.integers(0, 256, (*garmin_hw, 3), dtype=np.uint8)
    etg = rng.integers(0, 256, (*etg_hw, 3), dtype=np.uint8)
    ids = range(0, n, FPS // output_fps) if sparse else range(n)
    for name, img in (("video_garmin", garmin), ("video_etg", etg)):
        folder = base / f"{name}_frames"
        folder.mkdir(parents=True, exist_ok=True)
        for i, frame in zip(ids, _frames(img, ids)):
            write_bmp(folder / f"{i:06d}.jpg", frame)
        if avi:
            write_avi(base / f"{name}.avi", _frames(img, range(n)), fps=FPS,
                      top_down=avi_top_down)

    def nan(k: int) -> str:
        return NAN_SPELLINGS[k % len(NAN_SPELLINGS)]

    # gaze: two readings a garmin frame, one on every 7th; gaps inside
    lines = ["frame_etg frame_gar X Y event_type timestamp"]
    for i in range(n):
        for r in range(1 if i % 7 == 3 else 2):
            x = 540 + 200 * np.sin(i / 40) + rng.normal(0, 2)
            y = 360 + 150 * np.cos(i / 50) + rng.normal(0, 2)
            xs, ys = f"{x:.2f}", f"{y:.2f}"
            if i % 37 == 5:
                xs = nan(i)
            if i % 41 == 9 and r == 1:
                ys = nan(i + 1)
            if not sparse and (i == 0 or i == n - 1):
                xs, ys = nan(i + 2), nan(i + 3)
            event = nan(i) if i % 53 == 11 else ("Fixation" if i % 9 else "Saccade")
            lines.append(f"{i} {i} {xs} {ys} {event} {i * 33 + r * 16}")
    (base / "etg_samples.txt").write_text("\n".join(lines) + "\n")

    # GPS at the garmin rate: lat/lon degrees; gaps inside every column
    xy, heading = trajectory(n, seed, turn)
    latlon = inverse_gps_coordinates(xy)
    rows = []
    for i in range(n):
        speed, course = f"{10.0 * 3.6:.2f}", f"{np.degrees(heading[i]) % 360:.2f}"
        lat, lon = f"{latlon[i, 0]:.10f}", f"{latlon[i, 1]:.10f}"
        if i % 29 == 7:
            speed = nan(i)
        if i % 31 == 13:
            course = nan(i + 1)
        if i % 43 == 17:
            lat = lon = nan(i + 2)
        if i % 47 == 21:
            lon = nan(i + 3)
        if not sparse and (i < 2 or i >= n - 2):
            lat, lon = nan(i), nan(i + 4)
        rows.append(f"{i}\t{speed}\t{course}\t{lat}\t{lon}")
        if not sparse and i == n // 2:
            rows.append(rows[-1])  # a duplicated frame: the join repeats its gaze row
    (base / "speed_course_coord.txt").write_text("\n".join(rows) + "\n")
    return base


def build_dreyeve_fixture(root, session_ids=(1, 2), duration_s: float = 20.0,
                          garmin_hw: Tuple[int, int] = (36, 64),
                          etg_hw: Tuple[int, int] = (36, 64), seed: int = 0,
                          turn: float = 1.0, sparse: bool = False, avi: bool = False,
                          avi_top_down: bool = False) -> Path:
    """Sessions ``session_ids`` (session ``s`` seeded ``seed + s``) and the
    design table under ``root``."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for sid in session_ids:
        build_session(root, sid, duration_s=duration_s, garmin_hw=garmin_hw, etg_hw=etg_hw,
                      seed=seed + sid, turn=turn, sparse=sparse, avi=avi,
                      avi_top_down=avi_top_down)
    design = [f"{sid}\tMorning\tSunny\t{SCENES[sid % 3]}\t{sid % 8 + 1}\t"
              f"{'train' if sid < 38 else 'test'}" for sid in session_ids]
    (root / "dr(eye)ve_design.txt").write_text("\n".join(design) + "\n")
    return root
