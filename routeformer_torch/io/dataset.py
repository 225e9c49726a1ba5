"""GEM (Routeformer) dataset (counterpart of ``routeformer_tpu/io/dataset.py``).

Loads the raw GoPro MP4s, the Pupil Labs eye-tracker recording and the
hand-corrected GPS CSVs, aligns the three sensor clocks, windows them
into (input_length, target_length) samples, filters by PCI and caches.
Layout, splits, camera intrinsics, rates and the per-subject special cases
are the JAX dataset's (reference dataset.py:98-252):

  root/01GoPro/<subject>/{left,right}/GH0*.MP4
  root/02EyeTracker/<subject>/{world.mp4, world.intrinsics,
      world_timestamps.npy, gaze.pldata, gaze_timestamps.npy,
      info.invisible.json, info.player.json}
  root/03CorrectedGPS/<subject>/GH0*_*.csv

It needs only numpy, scipy and the standard library: GPMF through
``io/mp4.py`` and ``io/gpmf.py``, pldata and intrinsics through the
port's msgpack reader (``io/file_methods.py``), the corrected GPS through
``csv``, frames through ``io/video.py`` (``'raw '`` recordings by the
port's reader, compressed ones through cv2 where it can be imported; without
cv2 and without a sample cache, a compressed recording raises
``ImportError`` when the dataset is built), the
undistort, crop and resize through ``ops/image.py``, and the sample cache
in zlib (``io/cache.py``, under ``routeformer_torch_dataset/``; the PCI
index cache is ``torch_gem_pci_step<step>_fps<fps>.json``). Samples,
indices and values are the JAX dataset's; videos are THWC (or TCHW), uint8
or float16. ``stitch_videos`` adds the JAX dataset's ``stitched_video``
(``io/stitcher.py``: the left and right views as float32 in [0, 1] onto one
double-width canvas, float16 out), warped on ``stitch_device`` (the card
unless ``"cpu"``); it needs cv2 for the homography. ``with_audio`` adds
``left_audio``, ``right_audio`` (the GoPros) and ``front_audio`` (the
world recording, with the gaze) as ``(T, 1)`` float32 at ``AUDIO_FPS``,
trimmed to a common length (``io/audio.py``: PCM tracks in Python, AAC
through the ffmpeg shim where it builds). Like every key, the audio goes
through the sample cache and the memory tier; the loader stacks it as the
JAX loader does, so windows whose audio differs in length cannot be
batched.
"""

import csv
import json
import threading
from datetime import timezone
from pathlib import Path
from typing import Any, Callable, Dict, List, Literal, Optional, Tuple, Union

import numpy as np

from routeformer_torch.io.audio import read_audio
from routeformer_torch.io.cache import SampleCache
from routeformer_torch.io.file_methods import load_object, load_pldata_file
from routeformer_torch.io.gaze import Radial_Dist_Camera, detect_fixations
from routeformer_torch.io.gpmf import build_gps_points
from routeformer_torch.io.mp4 import MP4
from routeformer_torch.io.resample import convert_gps_coordinates, pchip_resample
from routeformer_torch.io.video import WindowedVideoReader, read_video, require_decoder
from routeformer_torch.ops.image import (
    crop_columns,
    crop_horizontal,
    remap_table,
    resize_video_numpy,
    undistort_video_numpy,
)
from routeformer_torch.score.pci import estimate_pci_batch
from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.dataset")


def _sample_nbytes(obj) -> int:
    """Approximate RAM footprint of a sample (dict of arrays)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_sample_nbytes(v) for v in obj.values())
    return 64


def _freeze_sample(obj):
    """Mark every array in a cached sample read-only (in place): a
    downstream in-place mutation of a served batch then raises instead of
    silently corrupting the cached sample for every later epoch."""
    if isinstance(obj, np.ndarray):
        obj.flags.writeable = False
    elif isinstance(obj, dict):
        for v in obj.values():
            _freeze_sample(v)
    return obj


def _copy_sample(obj):
    """Shallow per-dict copy of a cached sample: consumers may freely
    replace keys (maybe_split_video etc.) without touching the cached
    nesting; the (read-only) arrays stay shared."""
    if isinstance(obj, dict):
        return {k: _copy_sample(v) for k, v in obj.items()}
    return obj


class GEMDataset:
    """GEM multimodal driving dataset."""

    GPS_STREAM_HANDLER = "GoPro MET"
    VIDEO_FPS = 30
    GAZE_FPS = 200
    # Audio sample rate of the recordings (reference dataset.py:189).
    AUDIO_FPS = 48000
    # Gaze for subjects 009 & 010 is recorded at 76 Hz (reference :202-203).
    ALTERNATIVE_GAZE_FPS = 76
    ALTERNATIVE_GAZE_SUBJECTS = ("009", "010")
    GAZE_RESOLUTION = (1088, 1080)
    LEFT_VIDEO_CAMERA_INTRINSICS = np.array(
        [
            [1710.426021931798, 0, 1884.2289110824929],
            [0, 836.09803935562263, 1176.4416598639007],
            [0, 0, 1],
        ]
    )
    LEFT_VIDEO_DISTORTION_COEFFICIENTS = np.array(
        [
            -0.031747058681490734,
            0.0030000759331449784,
            0.044056989783113468,
            -0.0026995745434254055,
        ]
    )
    RIGHT_VIDEO_CAMERA_INTRINSICS = LEFT_VIDEO_CAMERA_INTRINSICS
    RIGHT_VIDEO_DISTORTION_COEFFICIENTS = LEFT_VIDEO_DISTORTION_COEFFICIENTS

    DATA_SPLIT = {
        "train": ["001", "003", "005", "006", "007", "010"],
        "val": ["002", "004"],
        "train+val": ["001", "002", "003", "004", "005", "006", "007", "010"],
        "test": ["008", "009"],
    }

    def __init__(
        self,
        root: Union[str, Path] = "/data/routeformer",
        split: Union[Literal["train", "val", "train+val", "test"], List[str]] = "train",
        input_length: float = 8,
        target_length: float = 6,
        step_size: float = 2,
        avoid_overlap: bool = False,
        min_pci: Optional[float] = 20.0,
        max_pci: Optional[float] = None,
        output_fps: float = 5,
        crop_videos: bool = True,
        undistort_videos: bool = True,
        stitch_videos: bool = False,
        gopro_scaling_factor: float = 1.0,
        front_scaling_factor: float = 1.0,
        frame_transform: Optional[Callable] = None,
        video_transform: Optional[Callable] = None,
        output_format: str = "THWC",
        num_workers: int = 1,
        with_video: bool = True,
        with_audio: bool = False,
        with_gaze: bool = True,
        mask_nonfixations: bool = False,
        dilution_threshold: float = 500.0,
        use_cache: bool = False,
        cache_dir: Optional[Union[str, Path]] = None,
        max_cache_size: int = int(10e9),
        share_decode: bool = True,
        video_dtype: str = "float16",
        use_memory_cache: bool = False,
        max_memory_cache_size: int = int(100e9),
        stitch_device=None,
    ):
        self.root = Path(root)
        self.split = split if isinstance(split, list) else self.DATA_SPLIT[split]
        self.input_length = input_length
        self.target_length = target_length
        self.step_size = step_size
        self.avoid_overlap = avoid_overlap
        self.min_pci = min_pci
        self.max_pci = max_pci
        self.output_fps = output_fps
        self.crop_videos = crop_videos
        self.undistort_videos = undistort_videos
        self.stitch_videos = stitch_videos
        self.gopro_scaling_factor = gopro_scaling_factor
        self.front_scaling_factor = front_scaling_factor
        self.frame_transform = frame_transform
        self.video_transform = video_transform
        self.with_video = with_video
        self.with_audio = with_audio
        self.with_gaze = with_gaze
        self.mask_nonfixations = mask_nonfixations
        self.dilution_threshold = dilution_threshold
        # Shared sequential decode of overlapping sample windows (each
        # source frame decoded + preprocessed once, not ~7x — see
        # io/video.py WindowedVideoReader). Off by preference only; results
        # are identical either way (byte-real dataset tests run both).
        self.share_decode = share_decode
        # Wire format of served video tensors. "float16" converts on the
        # host like the reference (dataset.py:1506-1523); "uint8" keeps
        # frames uint8 through the sample cache and the host->device copy
        # (half the bytes) and the same conversion runs on the card
        # (ops/image.dequantize_videos): the values are bit-identical. The
        # preprocess chain (undistort/crop/resize) runs on uint8 either
        # way, as the reference orders it (dataset.py:1269-1270).
        if video_dtype not in ("float16", "uint8"):
            raise ValueError(
                f"video_dtype must be 'float16' or 'uint8', got {video_dtype}"
            )
        self.video_dtype = video_dtype
        self._video_readers: Dict[str, Any] = {}
        self._video_readers_lock = threading.Lock()
        self.use_cache = use_cache

        self.output_format = output_format.upper()
        if self.output_format not in ("THWC", "TCHW"):
            raise ValueError(
                f"output_format should be either 'THWC' or 'TCHW', got {output_format}."
            )
        if self.output_fps not in (1, 2, 3, 5, 10, 15, 30):
            raise ValueError(
                f"output_fps should be one of 1, 2, 3, 5, 10, 15 or 30, got {output_fps}."
            )
        if (
            self.avoid_overlap
            and self.step_size <= self.input_length
            and (self.min_pci is None and self.max_pci is None)
        ):
            logger.warning(
                "avoid_overlap is True without PCI constraints; ignoring it."
            )
            self.avoid_overlap = False

        self.input_video_frame_count = int(self.input_length * self.output_fps)
        self.target_video_frame_count = int(self.target_length * self.output_fps)
        self.input_audio_frame_count = int(self.input_length * self.AUDIO_FPS)
        self.target_audio_frame_count = int(self.target_length * self.AUDIO_FPS)
        self.input_gaze_frame_count = int(self.input_length * self.GAZE_FPS)
        self.target_gaze_frame_count = int(self.target_length * self.GAZE_FPS)
        self.alternative_input_gaze_frame_count = int(
            self.input_length * self.ALTERNATIVE_GAZE_FPS
        )
        self.alternative_target_gaze_frame_count = int(
            self.target_length * self.ALTERNATIVE_GAZE_FPS
        )

        if self.stitch_videos:
            from routeformer_torch.io.stitcher import ImageStitcher

            self.stitcher = ImageStitcher(device=stitch_device)

        # --- discovery ------------------------------------------------- #
        self.subjects = [s for s in self._gather_subjects() if s in self.split]
        if len(self.subjects) != len(self.split):
            logger.warning(
                "subjects in split (%d) != requested (%d)",
                len(self.subjects), len(self.split),
            )
        self.left_samples, self.right_samples = self._gather_gopro_samples()
        self.video_samples, self.gaze_samples = self._gather_eyetracker_samples()
        if self.with_video and not self.use_cache:
            # a recording with no decoder to read it fails here, before any work
            # (with a sample cache, cached samples need no decoder)
            for subject in self.subjects:
                for path in (self.left_samples[subject] + self.right_samples[subject]
                             + ([self.video_samples[subject]["video"]]
                                if self.with_gaze else [])):
                    require_decoder(path)
        self.corrected_gps_samples = self._gather_corrected_gps_samples()
        self.subject_sample_metadatas = self._gather_subject_sample_metadatas()

        self.corrected_gps_cache: Dict = {}
        self.gaze_data_cache: Dict = {}
        self._gaze_lock = threading.Lock()
        self._return_info = False

        self._sample_cache = None
        if self.use_cache:
            cache_root = (
                Path(cache_dir) / "routeformer_torch_dataset"
                if cache_dir is not None
                else Path(self.root) / ".sample_cache_torch"
            )
            self._sample_cache = SampleCache(
                cache_root,
                params_repr=self._params_repr(),
                max_size_bytes=max_cache_size,
                async_writes=True,
            )

        # In-RAM tier over the sample cache (the JAX DreyeveDataset's
        # memory-cache design; the reference's GEM dataset has no RAM tier):
        # steady-state epochs skip decoding and decompression entirely.
        # Bounded; size-accounted on insert.
        self.use_memory_cache = use_memory_cache
        self.max_memory_cache_size = max_memory_cache_size
        self._memory_cache: Dict[int, Any] = {}
        self._memory_cache_bytes = 0
        self._memory_cache_lock = threading.Lock()

        self._indexer = self._create_indexer(cache_dir)
        self._faulty_samples = set()
        self._faulty_sample_replacer = np.random.default_rng(42)
        logger.info("Dataset initialized with %d samples", len(self))

    # ------------------------------------------------------------------ #
    # discovery (reference :541-777)
    # ------------------------------------------------------------------ #

    def _gather_subjects(self) -> List[str]:
        subjects = []
        for subdir in self.root.iterdir():
            if not subdir.is_dir():
                continue
            subjects.append([s.name for s in subdir.iterdir() if s.is_dir()])
        common = set.intersection(*map(set, subjects)) if subjects else set()
        if not common:
            raise ValueError(f"No subjects found in {self.root}")
        return sorted(common)

    def _gather_gopro_samples(self):
        left, right = {}, {}
        for subject in self.subjects:
            left_subject = sorted(
                (self.root / "01GoPro" / subject / "left").glob("*.MP4")
            ) + sorted((self.root / "01GoPro" / subject / "links").glob("*.MP4"))
            right_subject = sorted(
                (self.root / "01GoPro" / subject / "right").glob("*.MP4")
            ) + sorted((self.root / "01GoPro" / subject / "rechts").glob("*.MP4"))
            left[subject], right[subject] = self._filter_gopro_samples(
                left_subject, right_subject
            )
        return left, right

    @staticmethod
    def _filter_gopro_samples(left, right):
        """Match left/right recordings by the GH0x prefix, ignore long-named
        derivatives (reference :614-649)."""
        right = list(right)
        left_filtered, right_filtered = [], []
        for lpath in left:
            for ridx, rpath in enumerate(right):
                if (
                    lpath.stem[:4] == rpath.stem[:4]
                    and len(lpath.stem) < 10
                    and len(rpath.stem) < 10
                ):
                    left_filtered.append(lpath)
                    right_filtered.append(rpath)
                    right.pop(ridx)
                    break
        return left_filtered, right_filtered

    def _gather_eyetracker_samples(self):
        videos, gaze = {}, {}
        for subject in self.subjects:
            base = self.root / "02EyeTracker" / subject
            videos[subject] = {
                "video": base / "world.mp4",
                "intrinsics": base / "world.intrinsics",
                "time": base / "world_timestamps.npy",
            }
            # subject 009 names the world video differently (reference :688-695)
            if not videos[subject]["video"].exists() and subject == "009":
                videos[subject]["video"] = base / "world_001.mp4"
                videos[subject]["time"] = base / "world_001_timestamps.npy"
            gaze[subject] = {
                "gaze": base / "gaze.pldata",
                "time": base / "gaze_timestamps.npy",
            }
        return videos, gaze

    def _gather_corrected_gps_samples(self):
        samples = {}
        for subject in self.subjects:
            candidates = sorted(
                (self.root / "03CorrectedGPS" / subject).glob("*.csv")
            )
            samples[subject] = [
                s
                for s in candidates
                if any(
                    s.stem.startswith(v.stem[:8])
                    for v in self.left_samples[subject] + self.right_samples[subject]
                )
            ]
        return samples

    # ------------------------------------------------------------------ #
    # metadata / clock alignment (reference :748-966, 1711-1797, 2082-2126)
    # ------------------------------------------------------------------ #

    def _read_video_metadata(self, file: Path) -> Dict[str, Any]:
        """Video duration/fps + GPS-clock start time from the GPMF track."""
        mp4 = MP4(file)
        start_time = 0.0
        try:
            track = mp4.gpmd_track()
            if track is None:
                raise ValueError("no GPMF track")
            raw = mp4.read_track(track, 0, 10)
            points, _ = build_gps_points(raw, self.dilution_threshold)
            if not points or points[0].time is None:
                raise ValueError("no timestamped GPS points")
            start_time = points[0].time.replace(tzinfo=timezone.utc).timestamp()
        except (ValueError, OSError) as e:
            logger.warning("Could not find GPS data in %s (%s); start=0", file, e)

        video = mp4.video_track()
        return {
            "duration": mp4.duration / mp4.timescale if mp4.timescale else 0.0,
            "video_fps": video.fps if video is not None else 0.0,
            "start_time": start_time,
        }

    def _get_gaze_metadata(self, subject: str) -> Dict[str, Any]:
        base = self.root / "02EyeTracker" / subject
        invisible = base / "info.invisible.json"
        player = base / "info.player.json"
        if not invisible.exists():
            raise FileNotFoundError(f"File {invisible} does not exist")
        if not player.exists():
            raise FileNotFoundError(f"File {player} does not exist")

        metadata = json.loads(invisible.read_text())
        player_metadata = json.loads(player.read_text())
        metadata["start_time_gaze"] = metadata["start_time"] / 1e9
        metadata["duration"] = metadata["duration"] / 1e9
        if metadata["start_time_gaze"] != player_metadata.get("start_time_synced_s"):
            logger.warning("Start time mismatch for subject %s", subject)

        gaze_paths = self.gaze_samples[subject]
        gaze_data = load_pldata_file(gaze_paths["gaze"].parent, "gaze")
        video_timestamps = np.load(self.video_samples[subject]["time"])

        metadata["start_time"] = (
            metadata["start_time_gaze"] - gaze_data.timestamps[0]
        )
        metadata["start_time_video"] = metadata["start_time"] + video_timestamps[0]

        intrinsics = load_object(self.video_samples[subject]["intrinsics"])
        metadata["camera_matrix"] = np.array(
            intrinsics["(1088, 1080)"]["camera_matrix"], dtype=np.float32
        )
        metadata["dist_coefs"] = np.array(
            intrinsics["(1088, 1080)"]["dist_coefs"], dtype=np.float32
        ).flatten()
        metadata["intrinsics"] = intrinsics
        metadata["frame_size"] = self.GAZE_RESOLUTION
        return metadata

    def _get_sample_metadata(self, left, right, gaze_metadata) -> Dict[str, Any]:
        """Three-clock alignment (reference :897-966): the shared origin is
        the latest stream start; per-stream offsets place each recording on
        the common GPS-clock timeline."""
        left_metadata = self._read_video_metadata(left)
        right_metadata = self._read_video_metadata(right)

        gps_start_time = max(
            left_metadata["start_time"],
            right_metadata["start_time"],
            gaze_metadata["start_time_gaze"],
            gaze_metadata["start_time_video"],
        )
        left_offset = max(0, gps_start_time - left_metadata["start_time"])
        right_offset = max(0, gps_start_time - right_metadata["start_time"])
        gaze_sampling_offset = max(
            0, gps_start_time - gaze_metadata["start_time_gaze"]
        )
        gaze_video_offset = max(
            0, gps_start_time - gaze_metadata["start_time_video"]
        )
        duration = min(
            left_metadata["duration"] - left_offset,
            right_metadata["duration"] - right_offset,
            gaze_metadata["duration"] - gaze_sampling_offset,
            gaze_metadata["duration"] - gaze_video_offset,
        )
        return {
            "duration": duration,
            "origin_time": gps_start_time,
            "left_offset": left_offset,
            "right_offset": right_offset,
            "gaze_sampling_offset": gaze_sampling_offset,
            "gaze_video_offset": gaze_video_offset,
            "left_metadata": left_metadata,
            "right_metadata": right_metadata,
            "gaze_metadata": gaze_metadata,
        }

    def _gather_subject_sample_metadatas(self):
        subject_infos = {}
        for subject in self.subjects:
            gaze_metadata = self._get_gaze_metadata(subject)
            info = {}
            for left, right, corr_gps in zip(
                self.left_samples[subject],
                self.right_samples[subject],
                self.corrected_gps_samples[subject],
            ):
                info[(left, right, corr_gps)] = self._get_sample_metadata(
                    left, right, gaze_metadata
                )
            subject_infos[subject] = info
        return subject_infos

    # ------------------------------------------------------------------ #
    # corrected GPS (reference :780-895)
    # ------------------------------------------------------------------ #

    def _interpolate_corrected_gps(self, corr_gps: Path, metadata) -> Tuple[np.ndarray, np.ndarray]:
        with open(corr_gps, newline="") as fh:
            rows = np.array([[float(v) for v in row[:3]] for row in csv.reader(fh) if row],
                            dtype=np.float64).reshape(-1, 3)
        xy = convert_gps_coordinates(rows[:, :2])
        seconds = rows[:, 2] / 1000.0

        (left, right, _), is_left = self._locate_gps_video(corr_gps, metadata)
        video_metadata = metadata
        origin_time = video_metadata["origin_time"]
        duration = video_metadata["duration"]
        offset = video_metadata["left_offset" if is_left else "right_offset"]
        timestamps = seconds + origin_time - offset

        grid, values = pchip_resample(
            timestamps, xy, origin_time, duration, self.output_fps
        )
        return grid, values

    def _locate_gps_video(self, corr_gps: Path, metadata):
        # the CSV prefix (GH0x00yz) names its source video (reference :824-838)
        for (left, right, gps_file) in [
            k for info in self.subject_sample_metadatas.values() for k in info
        ]:
            if gps_file == corr_gps:
                if left.stem.startswith(corr_gps.stem[:8]) or corr_gps.stem.startswith(
                    left.stem[:8]
                ):
                    return (left, right, gps_file), True
                return (left, right, gps_file), False
        raise ValueError(f"Corrected GPS file {corr_gps} not found")

    def _get_full_corrected_gps(self, corr_gps: Path, metadata):
        if corr_gps not in self.corrected_gps_cache:
            self.corrected_gps_cache[corr_gps] = self._interpolate_corrected_gps(
                corr_gps, metadata
            )
        return self.corrected_gps_cache[corr_gps]

    def _slice_gps(self, grid, values, start_posix, end_posix):
        mask = (grid >= start_posix) & (grid <= end_posix)
        return values[mask]

    # ------------------------------------------------------------------ #
    # indexer (reference :967-1033) — vectorized + cached
    # ------------------------------------------------------------------ #

    def _params_repr(self) -> str:
        return repr(
            (
                self.crop_videos, self.undistort_videos, self.stitch_videos,
                self.gopro_scaling_factor, self.front_scaling_factor,
                self.frame_transform, self.video_transform, self.output_format,
                self.dilution_threshold, self.with_video, self.with_gaze,
                self.with_audio, self.mask_nonfixations, self.video_dtype,
            )
        )

    def _create_indexer(self, cache_dir) -> Dict[int, Any]:
        chunk_size = self.input_length + self.target_length
        pci_cache_path = None
        pci_cache = {}
        if cache_dir is not None:
            pci_cache_path = (
                Path(cache_dir)
                / f"torch_gem_pci_step{self.step_size}_fps{self.output_fps}.json"
            )
            if pci_cache_path.exists():
                pci_cache = json.loads(pci_cache_path.read_text())

        indexer = {}
        index = 0
        dirty = False
        for subject in self.subjects:
            for (left, right, corr_gps), metadata in self.subject_sample_metadatas[
                subject
            ].items():
                duration = metadata["duration"]
                starts = []
                start_time = 0.0
                while start_time <= duration - chunk_size:
                    starts.append(start_time)
                    start_time += self.step_size
                if not starts:
                    continue

                cache_key = f"{subject}/{corr_gps.name}"
                if cache_key in pci_cache and len(pci_cache[cache_key]) == len(starts):
                    pcis = np.asarray(pci_cache[cache_key])
                else:
                    pcis = self._compute_window_pcis(corr_gps, metadata, starts)
                    pci_cache[cache_key] = [float(p) for p in pcis]
                    dirty = True

                # avoid_overlap: after accepting a window, jump ahead by
                # max(input_length, step_size) (reference :299-312, 1031)
                skip = (
                    max(1, int(np.ceil(max(self.input_length, self.step_size)
                                       / self.step_size)))
                    if self.avoid_overlap
                    else 1
                )
                i = 0
                while i < len(starts):
                    pci = pcis[i]
                    if (self.min_pci is not None and pci < self.min_pci) or (
                        self.max_pci is not None and pci > self.max_pci
                    ):
                        i += 1
                        continue
                    indexer[index] = {
                        "subject": subject,
                        "left": left,
                        "right": right,
                        "corr_gps": corr_gps,
                        "sample_start_time": starts[i],
                        "sample_duration": chunk_size,
                        "trajectory_metadata": metadata,
                        "pci": float(pci),
                    }
                    index += 1
                    i += skip

        if pci_cache_path is not None and dirty:
            pci_cache_path.parent.mkdir(parents=True, exist_ok=True)
            pci_cache_path.write_text(json.dumps(pci_cache))
        return indexer

    def _compute_window_pcis(self, corr_gps, metadata, starts) -> np.ndarray:
        grid, values = self._get_full_corrected_gps(corr_gps, metadata)
        origin = metadata["origin_time"]
        n_in = int(self.input_length * self.output_fps) + 1
        n_tgt = int(self.target_length * self.output_fps)

        inputs, targets = [], []
        for start_t in starts:
            gps_start = origin + start_t
            start_idx = int(round((gps_start - grid[0]) * self.output_fps))
            inp = values[start_idx : start_idx + n_in]
            tgt = values[start_idx + n_in : start_idx + n_in + n_tgt]
            if len(inp) < n_in or len(tgt) < n_tgt:
                inp = np.pad(inp, ((0, n_in - len(inp)), (0, 0)), mode="edge") if len(inp) else np.zeros((n_in, 2))
                tgt = np.pad(tgt, ((0, n_tgt - len(tgt)), (0, 0)), mode="edge") if len(tgt) else np.zeros((n_tgt, 2))
            inputs.append(inp)
            targets.append(tgt)

        return estimate_pci_batch(
            np.stack(inputs), np.stack(targets),
            curve_type="linear", lookback_length=6, frequency=self.output_fps,
        )

    # ------------------------------------------------------------------ #
    # item assembly (reference :1045-1650)
    # ------------------------------------------------------------------ #

    def __len__(self) -> int:
        return len(self._indexer)

    def __iter__(self):
        for idx in range(len(self)):
            yield self[idx]

    def get_with_info(self, idx: int):
        self._return_info = True
        try:
            item, info = self.__getitem__(idx)
        finally:
            self._return_info = False
        return item, info

    def _memory_cache_put(self, idx: int, data):
        """Store ``data`` (best-effort) and return the object to SERVE: a
        per-dict copy when stored, so the first (miss) consumer's key
        replacement can never corrupt the cached nesting — the same
        protection hits get via ``_copy_sample``."""
        size = _sample_nbytes(data)
        with self._memory_cache_lock:
            if (
                idx not in self._memory_cache
                and self._memory_cache_bytes + size
                < self.max_memory_cache_size
            ):
                # arrays become read-only: hits share them across epochs
                self._memory_cache[idx] = _freeze_sample(data)
                self._memory_cache_bytes += size
                return _copy_sample(data)
        return data

    def __getitem__(self, idx: int):
        if idx not in self._indexer:
            raise IndexError(f"Index {idx} is out of range")
        item = self._indexer[idx]

        if idx in self._faulty_samples:
            return self._replace_faulty(idx)

        if self.use_memory_cache:
            with self._memory_cache_lock:
                hit = self._memory_cache.get(idx)
            if hit is not None:
                hit = _copy_sample(hit)  # consumers may replace keys freely
                return (hit, item) if self._return_info else hit

        if self._sample_cache is not None:
            cached = self._sample_cache.fetch(repr(item) )
            if cached is not None:
                if cached.get("is_sample_ok", True):
                    cached.pop("is_sample_ok", None)
                    cached["pci"] = item["pci"]
                    if self.use_memory_cache:
                        cached = self._memory_cache_put(idx, cached)
                    return (cached, item) if self._return_info else cached
                self._faulty_samples.add(idx)
                return self._replace_faulty(idx)

        data, is_sample_ok = self._get_sample_data(
            item["subject"], item["left"], item["right"], item["corr_gps"],
            item["sample_start_time"], item["trajectory_metadata"],
        )
        data["pci"] = item["pci"]

        if self._sample_cache is not None:
            to_cache = dict(data)
            to_cache["is_sample_ok"] = is_sample_ok
            self._sample_cache.push(repr(item), to_cache)

        if not is_sample_ok:
            self._faulty_samples.add(idx)
            logger.warning("Sample %d is not valid; returning a random sample", idx)
            return self._replace_faulty(idx)

        if self.use_memory_cache:
            data = self._memory_cache_put(idx, data)
        return (data, item) if self._return_info else data

    def _replace_faulty(self, idx: int):
        next_idx = int(self._faulty_sample_replacer.integers(0, len(self)))
        return self.__getitem__(next_idx)

    def _get_sample_data(self, subject, left, right, corr_gps, start_time, metadata):
        gaze_metadata = metadata["gaze_metadata"]
        data, start_posix, end_posix = self._get_video_data(
            left, right, corr_gps, start_time, metadata
        )
        data.update(self._get_gaze_data(subject, gaze_metadata, start_posix, end_posix))
        data = self._check_sanity(data)
        if self.with_video and not self.share_decode:
            # shared decode applies the full per-frame chain at decode time
            # (undistort/crop/resize/f16), shared across windows
            data = self._apply_scaling(data)
            data = self._convert_to_float16(data)
        if self.stitch_videos:
            # the stitcher takes float32 in [0, 1] (uint8 wire frames scaled
            # here); the stitched stream is float16
            def f32(v):
                v = v.astype(np.float32)
                return v / 255.0 if data["left_video"].dtype == np.uint8 else v

            data["stitched_video"] = self.stitcher.stitch_sequence(
                f32(data["left_video"]), f32(data["right_video"])).astype(np.float16)
        data = self._apply_transforms(data)
        return self._train_target_split(data, subject)

    def _get_reader(self, path, make_transform) -> WindowedVideoReader:
        """Per-video shared decoder (created once, reused by all samples)."""
        key = str(path)
        with self._video_readers_lock:
            reader = self._video_readers.get(key)
            if reader is None:
                # keep enough past to serve out-of-order windows from
                # concurrent loader threads (window span + batch spread)
                keep_past = float(self.input_length + self.target_length) + 18.0
                reader = WindowedVideoReader(
                    path, self.output_fps, make_transform(),
                    keep_past_sec=keep_past,
                )
                self._video_readers[key] = reader
            return reader

    def _gopro_frame_transform(self, K, D):
        """Per-frame preprocess chain for shared decode, the same values as
        the _preprocess_gopro + _apply_scaling + _convert_to_float16 stages
        (each is per-frame, so running them at decode time changes
        nothing). With undistort and crop, the remap runs only on the
        columns the crop keeps."""
        undistort = self.undistort_videos
        crop = self.crop_videos
        sf = self.gopro_scaling_factor
        to_f16 = self.video_dtype == "float16"

        def transform(frames):
            if undistort:
                h, w = frames.shape[1:3]
                frames = remap_table(K, D, h, w).apply(
                    frames, crop_columns(w, 0.3, 0.7) if crop else slice(None))
            elif crop:
                frames = np.ascontiguousarray(crop_horizontal(frames, 0.3, 0.7))
            if sf != 1:
                h, w = frames.shape[1:3]
                frames = resize_video_numpy(frames, (int(h * sf), int(w * sf)))
            if to_f16 and frames.dtype == np.uint8:
                frames = frames.astype(np.float16) / 255.0
            return frames

        return transform

    def _front_frame_transform(self, camera_matrix, dist_coefs):
        """Shared-decode preprocess for the gaze (front) camera."""
        undistort = self.undistort_videos
        sf = self.front_scaling_factor
        to_f16 = self.video_dtype == "float16"

        def transform(frames):
            if undistort:
                frames = undistort_video_numpy(frames, camera_matrix, dist_coefs)
            if sf != 1:
                h, w = frames.shape[1:3]
                frames = resize_video_numpy(frames, (int(h * sf), int(w * sf)))
            if to_f16 and frames.dtype == np.uint8:
                frames = frames.astype(np.float16) / 255.0
            return frames

        return transform

    def _get_video_data(self, left, right, corr_gps, start, metadata):
        origin_time = metadata["origin_time"]
        left_offset = metadata["left_offset"]
        right_offset = metadata["right_offset"]
        end = start + self.input_length + self.target_length + 1 / self.VIDEO_FPS

        data = {}
        if self.with_video:
            if self.share_decode:
                left_video = self._get_reader(
                    left,
                    lambda: self._gopro_frame_transform(
                        self.LEFT_VIDEO_CAMERA_INTRINSICS,
                        self.LEFT_VIDEO_DISTORTION_COEFFICIENTS,
                    ),
                ).read(start + left_offset, end + left_offset)["video"]
                right_video = self._get_reader(
                    right,
                    lambda: self._gopro_frame_transform(
                        self.RIGHT_VIDEO_CAMERA_INTRINSICS,
                        self.RIGHT_VIDEO_DISTORTION_COEFFICIENTS,
                    ),
                ).read(start + right_offset, end + right_offset)["video"]
            else:
                left_video = read_video(
                    left, start + left_offset, end + left_offset, self.output_fps
                )["video"]
                right_video = read_video(
                    right, start + right_offset, end + right_offset, self.output_fps
                )["video"]

                left_video, right_video = self._preprocess_gopro(
                    left_video, right_video
                )
            data["left_video"] = left_video
            data["right_video"] = right_video

        if self.with_audio:
            # the video decode's per-camera windows (reference :2026-2040)
            data["left_audio"] = read_audio(
                left, start + left_offset, end + left_offset)["audio"]
            data["right_audio"] = read_audio(
                right, start + right_offset, end + right_offset)["audio"]

        start_posix = origin_time + start
        end_posix = origin_time + end
        grid, values = self._get_full_corrected_gps(corr_gps, metadata)
        data["gps"] = self._slice_gps(grid, values, start_posix, end_posix)
        return data, start_posix, end_posix

    def _preprocess_gopro(self, left_video, right_video):
        """Undistort + crop, host-side (reference :1293-1338)."""
        out = []
        for video, K, D in (
            (left_video, self.LEFT_VIDEO_CAMERA_INTRINSICS,
             self.LEFT_VIDEO_DISTORTION_COEFFICIENTS),
            (right_video, self.RIGHT_VIDEO_CAMERA_INTRINSICS,
             self.RIGHT_VIDEO_DISTORTION_COEFFICIENTS),
        ):
            if video.size == 0:
                out.append(video)
                continue
            frames = video
            if self.undistort_videos:
                frames = undistort_video_numpy(frames, K, D)
            if self.crop_videos:
                frames = np.ascontiguousarray(crop_horizontal(frames, 0.3, 0.7))
            out.append(frames)
        return out[0], out[1]

    def _get_gaze_data(self, subject, gaze_metadata, start_posix, end_posix):
        end_posix = end_posix + 10 / self.GAZE_FPS
        if not self.with_gaze:
            return {}
        data = {}
        world = self._read_world_video(subject, gaze_metadata, start_posix, end_posix)
        if "video" in world:
            data["front_video"] = world["video"]
        if self.with_audio:
            # the front audio rides the world recording (reference
            # :1849-1850), over the front video's window
            data["front_audio"] = read_audio(
                self.video_samples[subject]["video"],
                start_posix - gaze_metadata["start_time_video"],
                end_posix - gaze_metadata["start_time_video"])["audio"]
        data["gaze"] = self._read_gaze_data(
            subject, gaze_metadata, start_posix, end_posix
        )
        return data

    def _read_world_video(self, subject, gaze_metadata, start_posix, end_posix):
        video_paths = self.video_samples[subject]
        start_sec = start_posix - gaze_metadata["start_time_video"]
        end_sec = end_posix - gaze_metadata["start_time_video"]
        if self.share_decode:
            video_data = self._get_reader(
                video_paths["video"],
                lambda: self._front_frame_transform(
                    gaze_metadata["camera_matrix"], gaze_metadata["dist_coefs"]
                ),
            ).read(start_sec, end_sec)
            return (
                {"video": video_data["video"]} if video_data["video"].size else {}
            )
        video_data = read_video(
            video_paths["video"], start_sec, end_sec, self.output_fps
        )
        data = {}
        if video_data["video"].size:
            frames = video_data["video"]
            if self.undistort_videos:
                frames = undistort_video_numpy(
                    frames,
                    gaze_metadata["camera_matrix"],
                    gaze_metadata["dist_coefs"],
                )
            data["video"] = frames
        return data

    def _gaze_data(self, key, gaze_metadata):
        """A subject's gaze positions, posix timestamps and fixation mask,
        computed once."""
        if key in self.gaze_data_cache:
            return self.gaze_data_cache[key]

        gaze_data = load_pldata_file(key.parent, "gaze")
        gaze_list = [d for d in gaze_data.data if d["topic"] == "gaze.pi"]
        is_fixation = detect_fixations(gaze_metadata, gaze_list)
        if isinstance(is_fixation, tuple):
            is_fixation = np.zeros(len(gaze_list), dtype=bool)
        gaze_pos = np.array([d["norm_pos"] for d in gaze_list], dtype=np.float64)
        gaze_timestamps = np.array(
            [d["timestamp"] + gaze_metadata["start_time_gaze"] for d in gaze_list],
            dtype=np.float64,
        )
        self.gaze_data_cache[key] = (gaze_pos, gaze_timestamps, is_fixation)
        return self.gaze_data_cache[key]

    def _read_gaze_data(self, subject, gaze_metadata, start_posix, end_posix):
        gaze_paths = self.gaze_samples[subject]
        key = gaze_paths["gaze"]
        with self._gaze_lock:  # loader threads wait for one fixation pass
            gaze_pos, gaze_timestamps, is_fixation = self._gaze_data(key, gaze_metadata)

        gaze_px = gaze_pos * np.array(self.GAZE_RESOLUTION)[None]
        filt = (gaze_timestamps >= start_posix) & (gaze_timestamps <= end_posix)
        gaze_px = gaze_px[filt]
        fix = is_fixation[filt]
        if len(gaze_px) == 0:
            logger.warning("No gaze data for subject %s in window", subject)
            return np.empty((0, 2), dtype=np.float32)

        if self.undistort_videos:
            cam = Radial_Dist_Camera(
                "world", self.GAZE_RESOLUTION,
                gaze_metadata["camera_matrix"], gaze_metadata["dist_coefs"],
            )
            und = cam.undistort_normalized(
                (gaze_px - [cam.K[0, 2], cam.K[1, 2]]) / [cam.K[0, 0], cam.K[1, 1]]
            )
            gaze_px = und * [cam.K[0, 0], cam.K[1, 1]] + [cam.K[0, 2], cam.K[1, 2]]

        gaze_norm = gaze_px / np.array(self.GAZE_RESOLUTION)
        if self.mask_nonfixations:
            gaze_norm[~fix] = -1
        return gaze_norm

    # ------------------------------------------------------------------ #
    # postprocessing (reference :1346-1680)
    # ------------------------------------------------------------------ #

    def _check_sanity(self, data):
        if self.with_video:
            keys = ["left_video", "right_video"] + (
                ["front_video"] if self.with_gaze and "front_video" in data else []
            )
            lengths = [data[k].shape[0] for k in keys if data[k].size]
            if lengths and len(set(lengths)) > 1:
                min_len = min(lengths)
                logger.warning("Video lengths differ %s; trimming to %d", lengths, min_len)
                for k in keys:
                    data[k] = data[k][:min_len]
        if self.with_audio:
            # the three audio streams trimmed to a common length
            # (reference :1379-1390)
            keys = [k for k in ("left_audio", "right_audio", "front_audio") if k in data]
            lengths = [data[k].shape[0] for k in keys]
            if lengths and len(set(lengths)) > 1:
                min_len = min(lengths)
                logger.warning("Audio lengths differ %s; trimming to %d", lengths, min_len)
                for k in keys:
                    data[k] = data[k][:min_len]
        return data

    def _apply_scaling(self, data):
        jobs = []
        if self.gopro_scaling_factor != 1:
            jobs += [("left_video", self.gopro_scaling_factor),
                     ("right_video", self.gopro_scaling_factor)]
        if self.front_scaling_factor != 1 and "front_video" in data:
            jobs.append(("front_video", self.front_scaling_factor))
        for key, factor in jobs:
            video = data[key]
            if video.size == 0:
                continue
            h, w = video.shape[1:3]
            out_hw = (int(h * factor), int(w * factor))
            data[key] = resize_video_numpy(video, out_hw)
        return data

    def _convert_to_float16(self, data):
        if self.video_dtype == "uint8":
            return data
        for key in ("left_video", "right_video", "front_video", "stitched_video"):
            if key in data and data[key].dtype == np.uint8:
                data[key] = data[key].astype(np.float16) / 255.0
        return data

    def _apply_transforms(self, data):
        if self.frame_transform is not None:
            for key in ("left_video", "right_video", "front_video", "stitched_video"):
                if key in data:
                    data[key] = np.stack(
                        [self.frame_transform(f) for f in data[key]]
                    )
        if self.video_transform is not None:
            for key in ("left_video", "right_video", "front_video", "stitched_video"):
                if key in data:
                    data[key] = self.video_transform(data[key])
        return data

    def _get_frame_counts(self, key: str, subject: str):
        if "audio" in key:
            return self.input_audio_frame_count, self.target_audio_frame_count
        if "video" in key or key == "gps":
            return self.input_video_frame_count, self.target_video_frame_count
        if "gaze" in key:
            if subject in self.ALTERNATIVE_GAZE_SUBJECTS:
                return (
                    self.alternative_input_gaze_frame_count,
                    self.alternative_target_gaze_frame_count,
                )
            return self.input_gaze_frame_count, self.target_gaze_frame_count
        raise ValueError(f"Unknown key {key}")

    def _train_target_split(self, data, subject):
        """Window into {train, target} with shortness detection + the
        76->200 Hz gaze upsample for subjects 009/010 (reference :1606-1680)."""
        data_keys = [k for k in data.keys() if k != "pci"]
        is_sample_ok = True
        out = {}
        for phase in ("train", "target"):
            phase_data = {}
            for key in data_keys:
                input_count, target_count = self._get_frame_counts(key, subject)
                phase_start = 0 if phase == "train" else input_count
                phase_end = (
                    input_count if phase == "train" else input_count + target_count
                )
                phase_data[key] = data[key][phase_start:phase_end]
                if phase == "target" and data[key].shape[0] < phase_end:
                    logger.warning(
                        "Target data for %s shorter than expected (%d < %d)",
                        key, data[key].shape[0], phase_end,
                    )
                    is_sample_ok = False
            out[phase] = phase_data

        if is_sample_ok and subject in self.ALTERNATIVE_GAZE_SUBJECTS and self.with_gaze:
            in_count, tgt_count = (
                self.input_gaze_frame_count, self.target_gaze_frame_count,
            )
            for phase, count in (("train", in_count), ("target", tgt_count)):
                if "gaze" in out[phase]:
                    out[phase]["gaze"] = self._upsample_gaze_data(
                        out[phase]["gaze"], count
                    )

        if self.output_format == "TCHW":
            for phase in ("train", "target"):
                for key in list(out[phase]):
                    if "video" in key and out[phase][key].ndim == 4:
                        out[phase][key] = out[phase][key].transpose(0, 3, 1, 2)
        return out, is_sample_ok

    @staticmethod
    def _upsample_gaze_data(gaze_data: np.ndarray, target_frame_count: int):
        """Linear upsample of 76 Hz gaze back to the 200 Hz grid
        (reference :1662-1680)."""
        if gaze_data.shape[0] == 0:
            return np.zeros((target_frame_count, 2), dtype=gaze_data.dtype)
        src = np.linspace(0.0, 1.0, gaze_data.shape[0])
        dst = np.linspace(0.0, 1.0, target_frame_count)
        return np.stack(
            [np.interp(dst, src, gaze_data[:, c]) for c in range(gaze_data.shape[1])],
            axis=-1,
        ).astype(gaze_data.dtype)
