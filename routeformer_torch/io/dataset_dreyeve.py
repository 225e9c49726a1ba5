"""DR(eye)VE dataset (counterpart of ``routeformer_tpu/io/dataset_dreyeve.py``).

Sessions of garmin and eye-tracking-glasses (ETG) recordings, their frames
as ``NN/video_{garmin,etg}_frames/{:06d}.jpg`` or ``NN/video_*.avi``; the
gaze log ``etg_samples.txt`` joined to the GPS log
``speed_course_coord.txt`` on the garmin frame id; 14 s windows every 2 s
with their PCI (a versioned JSON cache); optional PCI-balanced bins; a
zlib sample cache and an in-memory tier. Windows, PCI values, bins and
items are the JAX dataset's.

It needs numpy, scipy and the standard library:

- the metadata join is ``pandas``' (``read_csv``, ``interpolate``,
  ``groupby().agg``, ``join``) written out over ``csv`` rows and numpy
  columns (``read_columns``, ``interpolate_linear``,
  ``interpolate_pchip_inside``, ``join_session``), with pandas' NaN
  tokens, dtype inference, sorted group keys and left-ordered inner join;
- frames are decoded by their content (``io/frames.py``): BMP and PPM in
  numpy, an uncompressed ``BI_RGB`` AVI by the port's reader, JPEG and
  compressed video through cv2 where it can be imported. Without cv2 (the
  card's machine) a session of JPEG frames raises ``ImportError`` naming a
  frame when the dataset is built, unless it reads from a sample cache;
- the ``cv2.resize(INTER_AREA)`` scaling is ``ops/image.AreaTable``, bit
  for bit; each scaled frame is kept in a bounded memo, so the windows
  that share a frame (a frame sits in up to seven 14 s windows 2 s apart)
  read and scale it once;
- the sample cache is ``io/cache.SampleCache`` (zlib, ``.rfz`` files under
  ``dreyeve_dataset/torch_items``); the PCI cache is the JAX package's
  file, ``dreyeve_dataset/pci_stepsize-<step>.json``, in its layout, so
  either package reads the other's.

The balanced split draws from its own ``random.Random(seed)``, the
sequence the JAX dataset draws from the seeded global ``random``.
"""

import csv
import json
import math
import random
import sys
import tempfile
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Literal, Optional, Union

import numpy as np

from routeformer_torch.io.cache import SampleCache
from routeformer_torch.io.dataset import _copy_sample, _freeze_sample
from routeformer_torch.io.frames import (
    AviReader,
    read_avi_frames,
    read_frame,
    require_avi_decoder,
    require_frame_decoder,
)
from routeformer_torch.io.resample import convert_gps_coordinates
from routeformer_torch.ops.image import resize_area
from routeformer_torch.score.pci import estimate_pci_batch
from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.dataset_dreyeve")

# read_csv's default NaN tokens (pandas ``io.parsers`` ``STR_NA_VALUES``)
NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
GAZE_COLUMNS = ("frame_etg", "frame_gar", "X", "Y", "event_type", "timestamp")
GPS_COLUMNS = ("frame", "speed", "course", "lat", "lon")
DESIGN_COLUMNS = ("session_id", "time", "weather", "scene", "subject", "set")
N_READINGS = 2  # gaze readings kept per garmin frame
FRAME_MEMO_BYTES = 2e9  # scaled frames kept by (file, frame id, scale)


class DreyeveDesignScene:
    DOWNTOWN = "Downtown"
    HIGHWAY = "Highway"
    COUNTRYSIDE = "Countryside"


class DreyeveDesignWeather:
    SUNNY = "Sunny"
    CLOUDY = "Cloudy"
    RAINY = "Rainy"


class DreyeveDesignTime:
    MORNING = "Morning"
    EVENING = "Evening"
    NIGHT = "Night"


# --------------------------------------------------------------------- #
# read_csv, interpolate, groupby and join, without pandas
# --------------------------------------------------------------------- #


def _column(cells: List[Optional[str]]) -> np.ndarray:
    """One column's cells (None for a NaN token) as read_csv types it:
    int64 when every value is an integer, float64 when every value is a
    number or a NaN is present among integers, else object (str, NaN)."""
    values = [c for c in cells if c is not None]
    for kind in (int, float):
        try:
            parsed = [kind(c) for c in values]
        except ValueError:
            continue
        if kind is int and len(values) == len(cells):
            return np.array(parsed, np.int64)
        out = np.full(len(cells), np.nan)
        out[[i for i, c in enumerate(cells) if c is not None]] = parsed
        return out
    return np.array([np.nan if c is None else c for c in cells], dtype=object)


def read_columns(path, sep: str, names, skiprows: int = 0) -> Dict[str, np.ndarray]:
    """``pandas.read_csv(path, sep=sep, header=None, names=names,
    skiprows=skiprows)`` as ``{name: column}``: blank lines skipped, a short
    row's missing fields NaN, pandas' NaN tokens, its column types."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter=sep, quotechar='"')][skiprows:]
    rows = [r for r in rows if r and any(r)]
    cells = [[None] * len(rows) for _ in names]
    for i, row in enumerate(rows):
        for j in range(min(len(row), len(names))):
            cells[j][i] = None if row[j] in NA_TOKENS else row[j]
    return {name: _column(col) for name, col in zip(names, cells)}


def interpolate_linear(values: np.ndarray) -> np.ndarray:
    """``Series.interpolate()``: linear in position, leading NaNs kept,
    trailing NaNs filled with the last valid value."""
    values = np.asarray(values, np.float64)
    valid = ~np.isnan(values)
    if valid.all() or not valid.any():
        return values
    pos = np.arange(len(values))
    out = np.interp(pos, pos[valid], values[valid])
    out[: np.argmax(valid)] = np.nan
    return out


def interpolate_pchip_inside(values: np.ndarray) -> np.ndarray:
    """``Series.interpolate(method="pchip", limit_area="inside")`` on a
    0..n-1 index: scipy's PCHIP through the valid points, evaluated only at
    the NaNs between the first and the last valid one."""
    from scipy.interpolate import pchip_interpolate

    values = np.asarray(values, np.float64)
    valid = ~np.isnan(values)
    if valid.all() or valid.sum() < 2:
        return values
    pos = np.arange(len(values))
    first, last = pos[valid][0], pos[valid][-1]
    inside = ~valid & (pos > first) & (pos < last)
    out = values.copy()
    if inside.any():
        out[inside] = pchip_interpolate(pos[valid], values[valid], pos[inside])
    return out


def _first_valid(values: np.ndarray):
    """groupby's ``"first"``: the first non-NaN value (NaN when none)."""
    for v in values:
        if not (isinstance(v, float) and math.isnan(v)):
            return v
    return np.nan


def group_gaze(gaze: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``gaze.groupby("frame_gar").agg({"frame_etg": "first", X, Y,
    event_type, timestamp: the first two rows' values (a lone row twice)})
    .reset_index()``: keys sorted, NaN keys dropped, rows in file order."""
    keys = gaze["frame_gar"]
    keep = ~np.isnan(keys) if keys.dtype.kind == "f" else np.ones(len(keys), bool)
    order = np.argsort(keys[keep], kind="stable")
    rows = np.flatnonzero(keep)[order]
    sorted_keys = keys[rows]
    starts = np.flatnonzero(np.r_[True, sorted_keys[1:] != sorted_keys[:-1]])
    ends = np.r_[starts[1:], len(rows)]
    out = {"frame_gar": sorted_keys[starts]}
    etg = gaze["frame_etg"]
    firsts = [_first_valid(etg[rows[a:b]]) for a, b in zip(starts, ends)]
    out["frame_etg"] = np.array(firsts, etg.dtype if etg.dtype.kind == "i" else np.float64)
    second = np.minimum(starts + 1, ends - 1)  # a lone row's first reading twice
    pick = np.stack([rows[starts], rows[second]], axis=1)
    for name in ("X", "Y", "event_type", "timestamp"):
        out[name] = gaze[name][pick]
    return out


class SessionMetadata:
    """One session's joined per-frame metadata: the columns of the JAX
    dataset's DataFrame (``frame_gar``, ``frame_etg``, ``X``/``Y``/
    ``event_type``/``timestamp`` as (n, 2) reading pairs, ``speed``,
    ``course``, ``lat``, ``lon`` (web-mercator x and y, as the JAX dataset
    stores them)), row for row."""

    COLUMNS = ("frame_gar", "frame_etg", "X", "Y", "event_type", "timestamp", "speed",
               "course", "lat", "lon")

    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __len__(self) -> int:
        return len(self.columns["frame_gar"])


def join_session(etg_samples_fpath, speed_course_fpath) -> SessionMetadata:
    """The JAX dataset's per-session join (``_generate_metadata``): gaze
    X/Y linearly interpolated then grouped per garmin frame; GPS converted
    to web-mercator (NaNs and all), speed/course linear and lat/lon PCHIP
    inside, rows without lat/lon dropped; an inner join of the groups on
    ``frame_gar`` against the GPS ``frame``, in the groups' order, a group
    repeated for each GPS row of its frame."""
    gaze = read_columns(etg_samples_fpath, " ", GAZE_COLUMNS, skiprows=1)
    for name in ("X", "Y"):
        gaze[name] = interpolate_linear(gaze[name])
    groups = group_gaze(gaze)

    gps = read_columns(speed_course_fpath, "\t", GPS_COLUMNS)
    xy = convert_gps_coordinates(np.stack([gps["lat"], gps["lon"]], axis=-1))
    gps["lat"], gps["lon"] = xy[:, 0], xy[:, 1]
    for name in ("course", "speed"):
        gps[name] = interpolate_linear(gps[name])
    for name in ("lat", "lon"):
        gps[name] = interpolate_pchip_inside(gps[name])
    keep = ~(np.isnan(gps["lat"]) | np.isnan(gps["lon"]))
    gps = {k: v[keep] for k, v in gps.items()}

    by_frame: Dict = {}
    for i, frame in enumerate(gps["frame"].tolist()):
        by_frame.setdefault(frame, []).append(i)
    left, right = [], []
    for i, key in enumerate(groups["frame_gar"].tolist()):
        for j in by_frame.get(key, ()):
            left.append(i)
            right.append(j)
    left, right = np.array(left, np.int64), np.array(right, np.int64)
    columns = {k: v[left] for k, v in groups.items()}
    columns.update({k: gps[k][right] for k in ("speed", "course", "lat", "lon")})
    return SessionMetadata(columns)


# --------------------------------------------------------------------- #
# File structure
# --------------------------------------------------------------------- #


class DreyeveFileStructureSession:
    """Per-session paths (reference dataset_dreyeve.py:173-225)."""

    def __init__(self, root: Union[str, Path], session_id: int):
        self.session_id = session_id
        base = Path(root).resolve() / f"{session_id:02d}"
        self.mean_frame_fpath = base / "mean_frame.png"
        self.mean_gt_fpath = base / "mean_gt.png"
        self.etg_samples_fpath = base / "etg_samples.txt"
        self.speed_course_fpath = base / "speed_course_coord.txt"
        self.video_etg_fpath = base / "video_etg.avi"
        self.video_garmin_fpath = base / "video_garmin.avi"
        self.video_etg_frames_fpath = base / "video_etg_frames" / "{:06d}.jpg"
        self.video_garmin_frames_fpath = base / "video_garmin_frames" / "{:06d}.jpg"

    def build_frames(self):
        """Explode the videos to JPEG frames, as the JAX package does it
        (``cv2.VideoCapture`` and ``cv2.imwrite``): ``ImportError`` naming
        the video where cv2 cannot be imported."""
        for video, pattern in ((self.video_etg_fpath, self.video_etg_frames_fpath),
                               (self.video_garmin_fpath, self.video_garmin_frames_fpath)):
            if not video.exists():
                continue
            try:
                import cv2
            except ImportError as e:
                raise ImportError(f"{video}: exploding it to JPEG frames needs cv2, which "
                                  "cannot be imported here") from e
            pattern.parent.mkdir(parents=True, exist_ok=True)
            cap = cv2.VideoCapture(str(video))
            i = 0
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                cv2.imwrite(str(pattern).format(i), frame)
                i += 1
            cap.release()


class DreyeveFileStructureSessionLibrary:
    """All session structures and the design table (reference :252-293);
    ``data_design`` is ``{column: list}`` of ``dr(eye)ve_design.txt``."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root).resolve()
        session_ids = sorted(
            int(d.name) for d in self.root.iterdir() if d.is_dir() and d.name.isdigit())
        self.sessions = {i: DreyeveFileStructureSession(root, i) for i in session_ids}
        design_fpath = self.root / "dr(eye)ve_design.txt"
        self.data_design = None
        if design_fpath.exists():
            table = read_columns(design_fpath, "\t", DESIGN_COLUMNS)
            self.data_design = {k: v.tolist() for k, v in table.items()}

    def __getitem__(self, key: int) -> DreyeveFileStructureSession:
        return self.sessions[key]

    def __iter__(self):
        return iter(self.sessions.values())

    def __len__(self):
        return len(self.sessions)

    def build_frames(self):
        for session in self.sessions.values():
            session.build_frames()


def _nbytes(obj) -> int:
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return sys.getsizeof(obj)


class FrameMemo:
    """Scaled frames by key, least recently used dropped past
    ``max_bytes``; thread-safe, the frames read-only. Two threads that miss
    the same key both compute it (the same array)."""

    def __init__(self, max_bytes: float = FRAME_MEMO_BYTES):
        self.max_bytes = max_bytes
        self._frames: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = self.misses = 0

    def __contains__(self, key: tuple) -> bool:
        with self._lock:
            return key in self._frames

    def get(self, key: tuple, make: Callable[[], np.ndarray]) -> np.ndarray:
        with self._lock:
            frame = self._frames.get(key)
            if frame is not None:
                self._frames.move_to_end(key)
                self.hits += 1
                return frame
            self.misses += 1
        frame = make()
        frame.flags.writeable = False
        with self._lock:
            if key not in self._frames:
                self._frames[key] = frame
                self._bytes += frame.nbytes
                while self._bytes > self.max_bytes and len(self._frames) > 1:
                    _, old = self._frames.popitem(last=False)
                    self._bytes -= old.nbytes
        return frame


# --------------------------------------------------------------------- #
# Dataset
# --------------------------------------------------------------------- #


class DreyeveDataset:
    """DR(eye)VE session dataset."""

    PCI_VERSION = 1
    DATA_CACHE_VERSION = 3.2
    DATA_SPLIT = {
        "train": list(range(1, 45)),
        "val": list(range(45, 60)),
        "train+val": list(range(1, 60)),
        "test": list(range(60, 75)),
    }

    def __init__(
        self,
        root_dir: Union[str, Path],
        split: Union[Literal["train", "val", "train+val", "test"], List[int]] = "train",
        input_length: float = 8,
        target_length: float = 6,
        step_size: float = 2,
        min_pci: Optional[float] = 0,
        max_pci: Optional[float] = None,
        output_fps: float = 5,
        gopro_scaling_factor: float = 1.0,
        front_scaling_factor: float = 1.0,
        output_format: str = "THWC",
        use_cache: bool = False,
        cache_dir: Optional[Union[str, Path]] = None,
        build_frames: bool = False,
        max_cache_size: int = int(10e9),
        use_frames: bool = True,
        use_memory_cache: bool = False,
        max_memory_cache_size: int = int(100e9),
        with_video: bool = True,
        crop_videos: bool = True,
        enable_pci_split: bool = False,
        pci_split_n_samples_per_bin: int = 200,
        max_length: Optional[int] = None,
        seed: int = 4242,
        filter_scene: Optional[List[str]] = None,
        video_dtype: str = "float16",
    ):
        self._random = random.Random(seed)
        self.index_column = "frame_gar"
        self.input_fps = 30
        self.output_fps = output_fps
        self.fps_divisor = int(self.input_fps // self.output_fps)
        if not (self.fps_divisor > 0 and self.input_fps % self.fps_divisor == 0):
            raise ValueError("fps_divisor must divide output_fps")
        self.step_size = step_size
        self.min_pci = min_pci
        self.max_pci = max_pci
        self.with_video = with_video
        self.crop_videos = crop_videos
        if video_dtype not in ("float16", "uint8"):
            raise ValueError(f"video_dtype must be 'float16' or 'uint8', got {video_dtype}")
        self.video_dtype = video_dtype
        self.use_frames = use_frames
        self.use_memory_cache = use_memory_cache
        self.max_memory_cache_size = max_memory_cache_size
        self.enable_pci_split = enable_pci_split
        self.filter_scene = filter_scene
        self.max_length = max_length
        self.gopro_scaling_factor = gopro_scaling_factor
        self.front_scaling_factor = front_scaling_factor
        self.output_format = output_format.upper()

        seq_length_in_seconds = input_length + target_length
        self.seq_length = int(self.input_fps / self.fps_divisor) * seq_length_in_seconds
        self.seq_length_input = int(self.input_fps / self.fps_divisor) * input_length
        self.seq_length_target = int(self.input_fps / self.fps_divisor) * target_length

        self.use_cache = use_cache
        self.cache_dpath = Path(cache_dir) / "dreyeve_dataset" if cache_dir is not None else None
        if self.use_cache:
            if self.cache_dpath is None:
                self.cache_dpath = Path(tempfile.mkdtemp())
            self.cache_dpath.mkdir(parents=True, exist_ok=True)
        self.cache_pci_fpath = (
            self.cache_dpath / (f"pci_stepsize-{self.step_size}.json"
                                if self.step_size != 1 else "pci.json")
            if self.cache_dpath else None)

        self._sample_cache = None
        if self.use_cache and with_video and self.cache_dpath is not None:
            self._sample_cache = SampleCache(
                self.cache_dpath / "torch_items",
                params_repr=repr((
                    self.gopro_scaling_factor, self.front_scaling_factor, self.output_format,
                    self.step_size, self.seq_length_input, self.seq_length_target,
                    self.fps_divisor, self.DATA_CACHE_VERSION)),
                max_size_bytes=max_cache_size, async_writes=True)

        self.split = split if isinstance(split, list) else self.DATA_SPLIT[split]
        self.fs_sessions = DreyeveFileStructureSessionLibrary(root_dir)
        if len(self.fs_sessions) == 0:
            raise ValueError(f"{root_dir}: no DR(eye)VE session found")

        if build_frames or (
            self.with_video and self.use_frames
            and not next(iter(self.fs_sessions)).video_garmin_frames_fpath.parent.exists()
        ):
            logger.info("Building frames...")
            self.fs_sessions.build_frames()

        self.metadata = self._generate_metadata(filter_scene=self.filter_scene)
        step_size_frames = int(self.step_size * self.input_fps)
        self.data = self._build_data(self.metadata, self.seq_length, step_size_frames,
                                     self.fps_divisor)
        self.data = [e for e in self.data if e["pci"] >= (self.min_pci or 0)]

        self.data_bins = {}
        if self.enable_pci_split:
            self.data = sorted(self.data, key=lambda x: x["pci"])
            (self.data_bins, self.data_bins_keys, self.bin_epoch_size) = self._build_pci_split(
                10, 70, 60, pci_split_n_samples_per_bin,
                split if isinstance(split, str) else "train", self.data)

        self._frame_memo = FrameMemo()
        self._avi_readers: Dict[str, AviReader] = {}
        self._avi_lock = threading.Lock()
        if self.with_video and not self.use_cache:
            # a session that needs a decoder this host lacks fails here, before
            # any work (a sample cache serves cached samples without decoding)
            self._require_decoders()

        logger.info("Number of data entries: %d", len(self.data))
        self.full_dataset: Dict = {}
        self.memory_cache_size = 0
        self._return_info = False

    # ------------------------------------------------------------------ #

    def _require_decoders(self) -> None:
        """The first frame of each stream of the first session with
        windows, by its content: ``ImportError`` naming it when it needs
        cv2 and cv2 cannot be imported."""
        for session_id, md in self.metadata.items():
            if len(md) == 0:
                continue
            session = self.fs_sessions[session_id]
            if self.use_frames:
                require_frame_decoder(
                    str(session.video_garmin_frames_fpath).format(int(md["frame_gar"][0])))
                require_frame_decoder(
                    str(session.video_etg_frames_fpath).format(int(md["frame_etg"][0])))
            else:
                require_avi_decoder(session.video_garmin_fpath)
                require_avi_decoder(session.video_etg_fpath)
            return

    def _build_pci_split(self, bin_step_size, max_bin, n_samples_per_bin_val,
                         n_samples_per_bin, split, data):
        """PCI-balanced binned sampling (reference :506-543)."""
        bin_skip = (self.min_pci or 0) // bin_step_size
        bins: Dict[int, list] = {}
        for entry in data:
            if entry["pci"] <= max_bin:
                key = int(entry["pci"] // bin_step_size) - int(bin_skip)
            else:
                key = max_bin // bin_step_size - int(bin_skip)
            bins.setdefault(key, []).append(entry)

        bin_epoch_size = None
        if split == "train":
            bin_epoch_size = n_samples_per_bin * len(bins)
            for key in bins:
                self._random.shuffle(bins[key])
        elif split == "val":
            bin_min = min(n_samples_per_bin_val, min(len(v) for v in bins.values()))
            bin_epoch_size = bin_min * len(bins)
            for key in bins:
                self._random.shuffle(bins[key])
                bins[key] = bins[key][:bin_min]
        return bins, sorted(bins.keys()), bin_epoch_size

    def _generate_metadata(self, filter_scene=None) -> Dict[int, SessionMetadata]:
        """Join per-frame gaze and GPS (reference :545-692) for the split's
        sessions (the JAX dataset joins every session and then keeps the
        split's: the same result)."""
        keep = set(self.split)
        design = self.fs_sessions.data_design
        if filter_scene is not None and design is not None:
            keep &= {sid for sid, scene in zip(design["session_id"], design["scene"])
                     if scene in filter_scene}
        return {s.session_id: join_session(s.etg_samples_fpath, s.speed_course_fpath)
                for s in self.fs_sessions if s.session_id in keep}

    def _build_data(self, metadata, seq_length, step_size_frames, fps_divisor=1):
        """Window index and PCI with the versioned JSON cache (reference
        :824-911), the PCI of every missing window in one batch call."""
        pci_dict = None
        should_rebuild = True
        if self.use_cache and self.cache_pci_fpath and self.cache_pci_fpath.exists():
            pci_dict = json.loads(self.cache_pci_fpath.read_text())
            should_rebuild = not (
                pci_dict.get("seq_length_full") == seq_length * fps_divisor
                and pci_dict.get("step_size") == step_size_frames
                and pci_dict.get("version") == self.PCI_VERSION)
        if should_rebuild or pci_dict is None:
            pci_dict = {"version": self.PCI_VERSION, "seq_length_full": seq_length * fps_divisor,
                        "step_size": step_size_frames, "pci": {}}

        dirty = False
        data = []
        n_in_full = self.seq_length_input * fps_divisor
        n_tgt_full = self.seq_length_target * fps_divisor
        for session_id, session_metadata in metadata.items():
            session_pci = pci_dict["pci"].setdefault(str(session_id), {})
            n_frames = len(session_metadata)
            starts = list(range(0, n_frames - seq_length * fps_divisor, step_size_frames))
            missing = [i for i in starts if str(i) not in session_pci]
            if missing:
                dirty = True
                latlon = np.stack([session_metadata["lat"], session_metadata["lon"]], axis=-1)
                inputs = np.stack([latlon[i: i + n_in_full] for i in missing])
                targets = np.stack(
                    [latlon[i + n_in_full: i + n_in_full + n_tgt_full] for i in missing])
                # 30 Hz windows at frequency=output_fps: the JAX dataset's quirk, kept
                pcis = estimate_pci_batch(inputs, targets, curve_type="linear",
                                          lookback_length=6, frequency=self.output_fps)
                for i, p in zip(missing, pcis):
                    session_pci[str(i)] = float(p)

            for i in starts:
                pci = session_pci[str(i)]
                if (self.min_pci is not None and pci < self.min_pci) or (
                        self.max_pci is not None and pci > self.max_pci):
                    continue
                data.append({"pci": pci, "session_id": session_id, "start_index": i,
                             "seq_length": seq_length, "fps_divisor": fps_divisor})

        if self.use_cache and self.cache_pci_fpath and dirty:
            self.cache_pci_fpath.write_text(json.dumps(pci_dict))
        return data

    # ------------------------------------------------------------------ #

    def _scaled(self, frame: np.ndarray, scaling_factor: float) -> np.ndarray:
        return frame if scaling_factor == 1.0 else resize_area(frame, scaling_factor)

    def _read_frames(self, frame_fpath, frame_ids, scaling_factor=1.0) -> np.ndarray:
        """The frame files of ``frame_ids``, scaled (reference
        ``__read_frames`` :925-951); THWC uint8 RGB."""
        pattern = str(frame_fpath)

        def frame(i):
            path = pattern.format(i)
            return self._frame_memo.get(
                (path, scaling_factor), lambda: self._scaled(read_frame(path), scaling_factor))

        return np.stack([frame(int(i)) for i in frame_ids], axis=0)

    def _avi_reader(self, video_fpath) -> AviReader:
        key = str(video_fpath)
        with self._avi_lock:
            reader = self._avi_readers.get(key)
            if reader is None:
                reader = self._avi_readers[key] = AviReader(key)
            return reader

    def _read_video_frames(self, video_fpath, frame_ids, scaling_factor=1.0) -> np.ndarray:
        """Frames ``frame_ids`` of a session's AVI, scaled (the JAX
        dataset's ``use_frames=False`` path), the missing ones read in one
        pass."""
        key, ids = str(video_fpath), [int(i) for i in frame_ids]
        need = [i for i in dict.fromkeys(ids) if (key, i, scaling_factor) not in self._frame_memo]
        read = read_avi_frames(key, need, self._avi_reader(key)) if need else {}
        absent = [i for i in need if i not in read]
        if absent:
            raise ValueError(f"frames {absent[:5]}... missing in {video_fpath}")

        def frame(i):
            def make():
                raw = read[i] if i in read else read_avi_frames(key, [i], self._avi_reader(key))[i]
                return self._scaled(raw, scaling_factor)

            return self._frame_memo.get((key, i, scaling_factor), make)

        return np.stack([frame(i) for i in ids], axis=0)

    def _get_uncached_item(self, session_id, start_index, seq_length, fps_divisor):
        """(reference __get_uncached_item :1005-1114)"""
        md = self.metadata[session_id]
        window = slice(start_index, start_index + seq_length * fps_divisor, fps_divisor)
        gaze_data = np.stack([md["X"][window], md["Y"][window]], axis=1).astype(np.float32)
        gps_data = np.stack([md["lat"][window], md["lon"][window]], axis=-1)

        gaze_data[:, 0] = gaze_data[:, 0] / 1080
        gaze_data[:, 1] = gaze_data[:, 1] / 720
        gaze_data = gaze_data.transpose(0, 2, 1)  # (T, readings, XY)
        gaze_seq_length_input = gaze_data.shape[1] * self.seq_length_input
        gaze_data = gaze_data.reshape(-1, 2)

        frames_gar = frames_etg = None
        if self.with_video:
            frame_ids_gar = md["frame_gar"][window]
            frame_ids_etg = md["frame_etg"][window]
            session = self.fs_sessions[session_id]
            if self.use_frames:
                frames_gar = self._read_frames(session.video_garmin_frames_fpath,
                                               frame_ids_gar, self.gopro_scaling_factor)
                frames_etg = self._read_frames(session.video_etg_frames_fpath,
                                               frame_ids_etg, self.front_scaling_factor)
            else:
                frames_gar = self._read_video_frames(session.video_garmin_fpath,
                                                     frame_ids_gar, self.gopro_scaling_factor)
                frames_etg = self._read_video_frames(session.video_etg_fpath,
                                                     frame_ids_etg, self.front_scaling_factor)

        train = {"gps": gps_data[: self.seq_length_input],
                 "gaze": gaze_data[:gaze_seq_length_input]}
        target = {"gps": gps_data[self.seq_length_input:],
                  "gaze": gaze_data[gaze_seq_length_input:]}
        if self.with_video:
            train["left_video"] = frames_gar[: self.seq_length_input]
            train["front_video"] = frames_etg[: self.seq_length_input]
            target["left_video"] = frames_gar[self.seq_length_input:]
            target["front_video"] = frames_etg[self.seq_length_input:]
        return {"train": train, "target": target}

    def _postprocess(self, data):
        """f16 conversion and the 15 %/35 % vertical crop (reference
        :1130-1141, :1219-1227); uint8 frames stay uint8 under
        ``video_dtype="uint8"`` (converted on the card, the same values)."""
        if self.with_video:
            if self.video_dtype == "float16":
                for phase in ("train", "target"):
                    for key in ("left_video", "front_video"):
                        v = data[phase][key]
                        if v.dtype == np.uint8:
                            data[phase][key] = v.astype(np.float16) / 255.0
            if self.crop_videos:
                for phase in ("train", "target"):
                    v = data[phase]["left_video"]
                    h = v.shape[1]
                    data[phase]["left_video"] = v[:, int(0.15 * h): int(0.65 * h)]
            if self.output_format == "TCHW":
                for phase in ("train", "target"):
                    for key in ("left_video", "front_video"):
                        data[phase][key] = data[phase][key].transpose(0, 3, 1, 2)
        return data

    # ------------------------------------------------------------------ #

    def __len__(self):
        length = len(self.data)
        if self.max_length is not None:
            length = min(length, self.max_length)
        if self.enable_pci_split and self.bin_epoch_size:
            length = min(length, self.bin_epoch_size)
        return length

    def entry(self, idx: int) -> dict:
        """The window ``idx`` serves (through the bins under the PCI split)."""
        if self.enable_pci_split:
            key = self.data_bins_keys[idx % len(self.data_bins)]
            return self.data_bins[key][(idx // len(self.data_bins)) % len(self.data_bins[key])]
        return self.data[idx]

    def __getitem__(self, idx):
        entry = self.entry(idx)
        if self.use_memory_cache and idx in self.full_dataset:
            # a per-dict copy of the (read-only) cached sample: a consumer's key
            # replacement or in-place write cannot corrupt it for later epochs
            hit = _copy_sample(self.full_dataset[idx])
            return (hit, entry) if self._return_info else hit

        pci = entry["pci"]
        if self._sample_cache is not None:
            cached = self._sample_cache.fetch(repr(entry))
            if cached is not None:
                cached["pci"] = pci
                cached = self._postprocess(cached)
                return (cached, entry) if self._return_info else cached

        data = self._get_uncached_item(entry["session_id"], entry["start_index"],
                                       entry["seq_length"], entry["fps_divisor"])
        data["pci"] = pci
        if self._sample_cache is not None:
            self._sample_cache.push(repr(entry), data)
        data = self._postprocess(data)

        if self.use_memory_cache:
            size = _nbytes(data)
            if self.memory_cache_size + size < self.max_memory_cache_size:
                self.full_dataset[idx] = _freeze_sample(data)
                self.memory_cache_size += size
                data = _copy_sample(data)
        return (data, entry) if self._return_info else data

    def get_with_info(self, idx: int):
        self._return_info = True
        try:
            item, info = self.__getitem__(idx)
        finally:
            self._return_info = False
        return item, info
