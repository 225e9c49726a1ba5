"""Host-side video reading (counterpart of ``routeformer_tpu/io/video.py``).

The output contract is the JAX reader's: RGB uint8 frames of the
``[start, end)`` second window, decimated to ``output_fps`` by a stride,
and an empty ``(0, 0, 0, 3)`` array with a warning when nothing can be
read. The track's sample entry picks the decoder, and a missing decoder
raises instead of falling back:

- ``'raw '`` (uncompressed RGB24, what the card's machine reads): the
  port's own reader (``RawCapture``), a numpy view of each sample at the
  offsets ``io/mp4.py`` resolves;
- any other codec (``avc1``, ``mp4v``, ``hvc1``, ...): ``cv2`` when it
  can be imported; else ``ImportError`` naming the codec and the file.

Both captures keep OpenCV's clock, which the window arithmetic of
``read_video`` and ``WindowedVideoReader`` relies on: a seek to ``t``
lands on frame ``floor(t * fps + 0.5)``, and the position read before a
frame is delivered is the previous frame's time (0 before the first
frame after opening). So a raw recording gives the windows a decoder would
give for the same frames.
"""

import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np

from routeformer_torch.io.mp4 import MP4
from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.video")

RAW_CODEC = "raw "
MEMO_BYTES = 256e6  # transformed frames a WindowedVideoReader keeps by index


class RawCapture:
    """Uncompressed RGB24 frames of an MP4's video track, read by offset,
    behind the ``VideoCapture`` calls the readers make."""

    def __init__(self, path: str, mp4: MP4):
        track = mp4.video_track()
        width, height, depth = track.visual
        if depth != 24:
            raise ValueError(f"{path}: 'raw ' video of depth {depth}; only RGB24 is read")
        self.shape = (height, width, 3)
        self._offsets = track.sample_offsets()
        self._times = track.sample_times()[: len(self._offsets)]
        if len(track.time_deltas) == 1 and track.time_deltas[0][1]:
            self.fps = track.timescale / track.time_deltas[0][1]
        else:
            self.fps = track.fps
        self._fd = os.open(path, os.O_RDONLY)
        self._next = 0
        self._last_time: Optional[float] = None

    @property
    def next_index(self) -> int:
        """Source index of the frame the next ``grab``/``read`` delivers."""
        return self._next

    def pos_msec(self) -> float:
        return 0.0 if self._last_time is None else self._last_time * 1000.0

    def seek_msec(self, msec: float) -> None:
        frame = int(msec * self.fps * 0.001 + 0.5)
        self._next = min(max(frame, 0), len(self._offsets))
        self._last_time = self._times[self._next - 1] if self._next > 0 else None

    def grab(self) -> bool:
        if self._next >= len(self._offsets):
            return False
        self._last_time = self._times[self._next]
        self._next += 1
        return True

    def read(self):
        index = self._next
        if not self.grab():
            return False, None
        offset, size = self._offsets[index]
        h, w, c = self.shape
        if size < h * w * c:
            raise ValueError(f"sample {index} holds {size} bytes, a frame needs {h * w * c}")
        data = os.pread(self._fd, size, offset)
        frame = np.frombuffer(data, np.uint8)
        if size != h * w * c:  # rows padded to a stride
            frame = frame[: h * (size // h)].reshape(h, size // h)[:, : w * c]
        return True, frame.reshape(h, w, c)

    def release(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


class Cv2Capture:
    """``cv2.VideoCapture`` behind the same calls, delivering RGB."""

    def __init__(self, path: str, cv2):
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0

    next_index = None  # a decoder's frame index after a seek is not exact

    def isOpened(self) -> bool:
        return self._cap.isOpened()

    def pos_msec(self) -> float:
        return self._cap.get(self._cv2.CAP_PROP_POS_MSEC)

    def seek_msec(self, msec: float) -> None:
        self._cap.set(self._cv2.CAP_PROP_POS_MSEC, msec)

    def grab(self) -> bool:
        return self._cap.grab()

    def read(self):
        ok, frame = self._cap.read()
        if not ok:
            return False, None
        return True, self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2RGB)

    def release(self) -> None:
        self._cap.release()


def _video_track(path):
    """``(mp4, its first video track)``, or ``(None, None)`` when the file is
    no readable MP4."""
    try:
        mp4 = MP4(path)
        return mp4, mp4.video_track()
    except (ValueError, OSError):
        return None, None


def _cv2_for(path: str, track):
    """cv2 for a track that needs a decoder; ``ImportError`` naming the
    codec and the file when cv2 cannot be imported (None when the file is
    no readable MP4: nothing names a codec)."""
    try:
        import cv2
    except ImportError as e:
        if track is None:
            return None
        raise ImportError(
            f"{path}: its video codec {track.codec!r} needs a decoder and cv2 cannot be "
            "imported here. Convert the recording to uncompressed 'raw ' RGB24 MP4s, or "
            "build the dataset's sample cache (use_cache=True) on a host with cv2: a "
            "cached sample is read back without decoding") from e
    return cv2


def require_decoder(path) -> None:
    """Raise the ``ImportError`` of ``_cv2_for`` now if reading ``path``
    would need cv2 and cv2 cannot be imported."""
    _, track = _video_track(str(path))
    if track is not None and track.codec != RAW_CODEC:
        _cv2_for(str(path), track)


def open_capture(path):
    """A capture for ``path`` chosen by its codec (module docstring), or
    None when the file cannot be opened (the caller warns and returns no
    frames)."""
    path = str(path)
    mp4, track = _video_track(path)
    if track is not None and track.codec == RAW_CODEC:
        try:
            return RawCapture(path, mp4)
        except (ValueError, OSError) as e:
            logger.warning("could not read raw video %s (%s)", path, e)
            return None
    cv2 = _cv2_for(path, track)
    if cv2 is None:
        return None
    cap = Cv2Capture(path, cv2)
    if not cap.isOpened():
        cap.release()
        return None
    return cap


def _stride(fps: float, output_fps: Optional[float]) -> int:
    if output_fps is not None and output_fps < fps:
        return int(round(fps / output_fps))
    return 1


def read_video(path, start_sec: float = 0.0, end_sec: float = float("inf"),
               output_fps: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Frames in [start_sec, end_sec), optionally decimated to
    ``output_fps``: ``{"video": (T, H, W, 3) uint8 RGB, "fps": ...}``."""
    path = str(path)
    cap = open_capture(path)
    if cap is None:
        logger.warning("could not open video %s; returning empty tensor", path)
        return {"video": np.zeros((0, 0, 0, 3), dtype=np.uint8), "fps": 0.0}
    try:
        fps = cap.fps
        if start_sec > 0:
            cap.seek_msec(start_sec * 1000.0)
        stride = _stride(fps, output_fps)
        frames = []
        decoded = 0
        while True:
            t = cap.pos_msec() / 1000.0
            if stride > 1 and decoded % stride != 0:
                if not cap.grab() or t >= end_sec:
                    break
                decoded += 1
                continue
            ok, frame = cap.read()
            if not ok or t >= end_sec:
                break
            decoded += 1
            frames.append(frame)
    finally:
        cap.release()
    if not frames:
        logger.warning("no frames decoded from %s in [%s, %s)", path, start_sec, end_sec)
        return {"video": np.zeros((0, 0, 0, 3), dtype=np.uint8), "fps": fps}
    return {"video": np.stack(frames), "fps": fps}


class WindowedVideoReader:
    """Shared sequential reader for overlapping ``[start, end)`` windows
    (the JAX reader's design and parity contract, ``io/video.py:87-360``
    there): each frame is read and put through ``transform`` once per
    sequential pass and kept in a bounded, time-indexed buffer; a window
    whose start lies on the pass's frame grid (a whole number of frames
    from the pass's seek, a multiple of the stride) is served from the
    buffer, its landing predicted by induction from the pass's second kept
    frame; a backward, off-grid or far-forward start takes a fresh seek,
    which is ``read_video``'s code path. Past frames older than
    ``keep_past_sec`` before the latest start are evicted.

    The port adds one thing, which changes no value: with the raw reader,
    whose frame indices are exact, the transformed frames are also kept by
    source index in a least-recently-used memo of up to ``MEMO_BYTES``
    that outlives a fresh seek. Shuffled loading seeks afresh often (a
    start before the pass's anchor, or evicted), and without the memo the
    same frames go through the transform again (~5 times each in a
    shuffled GEM epoch).

    Thread-safe: loader threads reading windows of one recording share its
    lock and its reads; different videos proceed in parallel."""

    def __init__(self, path, output_fps: Optional[float] = None,
                 transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                 keep_past_sec: float = 32.0, max_jump_sec: Optional[float] = None):
        self.path = str(path)
        self._memo: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._memo_size = 0
        self.output_fps = output_fps
        self.transform = transform
        self.keep_past_sec = keep_past_sec
        self.max_jump_sec = keep_past_sec if max_jump_sec is None else max_jump_sec
        self._lock = threading.Lock()
        self._cap = None
        self._fps: float = 0.0
        self._stride = 1
        self._decoded = 0
        self._eof = False
        self._times: List[float] = []
        self._frames: List[np.ndarray] = []
        self._buf_start: Optional[float] = None
        self._induction_ref: Optional[float] = None
        self._kept = 0
        self._max_start = -np.inf
        self.n_resets = 0

    def _reset(self, start_sec: float) -> bool:
        """Fresh seek: the ``read_video`` code path."""
        if self._cap is not None:
            self._cap.release()
        self._cap = open_capture(self.path)
        if self._cap is None:
            return False
        self._fps = self._cap.fps
        self._stride = _stride(self._fps, self.output_fps)
        if start_sec > 0:
            self._cap.seek_msec(start_sec * 1000.0)
        self._decoded = 0
        self._eof = False
        self._times.clear()
        self._frames.clear()
        self._buf_start = start_sec
        self._induction_ref = None
        self._kept = 0
        self.n_resets += 1
        return True

    def _decode_until(self, end_sec: float) -> None:
        """Advance until the next frame's time is ``>= end_sec`` (the
        ``read_video`` loop, leaving the capture open for later windows)."""
        while not self._eof:
            t = self._cap.pos_msec() / 1000.0
            if t >= end_sec:
                return
            if self._stride > 1 and self._decoded % self._stride != 0:
                if not self._cap.grab():
                    self._eof = True
                    return
                self._decoded += 1
                continue
            index = self._cap.next_index
            frame = self._memo.get(index) if index is not None else None
            if frame is not None:
                if not self._cap.grab():
                    self._eof = True
                    return
                self._memo.move_to_end(index)
            else:
                ok, frame = self._cap.read()
                if not ok:
                    self._eof = True
                    return
                if self.transform is not None:
                    frame = self.transform(frame[None])[0]
                if index is not None:
                    self._remember(index, frame)
            self._decoded += 1
            if self._kept == 1 and self._induction_ref is None:
                self._induction_ref = t
            self._kept += 1
            self._times.append(t)
            self._frames.append(frame)

    def _remember(self, index: int, frame: np.ndarray) -> None:
        if frame.nbytes > MEMO_BYTES:
            return
        self._memo[index] = frame
        self._memo_size += frame.nbytes
        while self._memo_size > MEMO_BYTES:
            _, old = self._memo.popitem(last=False)
            self._memo_size -= old.nbytes

    def _evict(self) -> None:
        cutoff = self._max_start - self.keep_past_sec
        drop = 0
        while drop < len(self._times) and self._times[drop] < cutoff:
            drop += 1
        if drop:
            del self._times[:drop]
            del self._frames[:drop]

    def read(self, start_sec: float, end_sec: float) -> Dict[str, np.ndarray]:
        """Frames of ``[start_sec, end_sec)`` with ``transform`` applied, as
        ``read_video`` returns them."""
        with self._lock:
            video = self._read_locked(start_sec, end_sec)
        if video is None or not len(video):
            logger.warning("no frames decoded from %s in [%s, %s)",
                           self.path, start_sec, end_sec)
            return {"video": np.zeros((0, 0, 0, 3), dtype=np.uint8), "fps": self._fps}
        return {"video": np.stack(video), "fps": self._fps}

    def _grid_landing(self, start_sec: float):
        """Where a fresh seek to ``start_sec`` would land in this pass:
        ``"anchor"``, a predicted recorded time, or None (off the grid)."""
        if self._buf_start is None or not self._fps:
            return None
        k = (start_sec - self._buf_start) * self._fps
        k_round = round(k)
        if abs(k - k_round) > 0.01 or k_round < 0 or k_round % self._stride != 0:
            return None
        if k_round == 0:
            return "anchor"
        if self._induction_ref is None:
            return None
        return self._induction_ref + (k_round - self._stride) / self._fps

    def _read_locked(self, start_sec: float, end_sec: float) -> Optional[List[np.ndarray]]:
        frame_period = 1.0 / self._fps if self._fps else 0.0
        landing = self._grid_landing(start_sec)
        if landing is not None and landing != "anchor":
            tail = self._times[-1] if self._times else self._buf_start
            if tail is not None and landing - tail > self.max_jump_sec:
                landing = None
        if landing == "anchor":
            reusable = self._cap is not None and self._kept == len(self._times)
        else:
            reusable = (self._cap is not None and landing is not None
                        and (not self._times or landing >= self._times[0] - frame_period / 2))
        lo = 0
        if not reusable:
            if not self._reset(start_sec):
                return None
            self._decode_until(end_sec)
        else:
            self._decode_until(end_sec)
            if landing != "anchor":
                half = frame_period / 2
                while lo < len(self._times) and self._times[lo] < landing - half:
                    lo += 1
                if not (lo < len(self._times) and abs(self._times[lo] - landing) <= half):
                    # the induction failed (a variable frame rate): seek afresh
                    if not self._reset(start_sec):
                        return None
                    self._decode_until(end_sec)
                    lo = 0
        hi = lo
        while hi < len(self._times) and self._times[hi] < end_sec:
            hi += 1
        self._max_start = max(self._max_start, start_sec)
        out = self._frames[lo:hi]
        self._evict()
        return out

    def close(self) -> None:
        with self._lock:
            if self._cap is not None:
                self._cap.release()
                self._cap = None
            self._times.clear()
            self._frames.clear()
            self._memo.clear()
            self._memo_size = 0
