"""Audio decode for ``GEMDataset(with_audio=True)`` (counterpart of
``routeformer_tpu/io/audio.py``).

The reference decodes the MP4's audio stream with PyAV over a pts window,
concatenates the frames and averages the channels (reference
``routeformer/io/dataset.py:2128-2278``). The port keeps its window
semantics:

- window bounds in the stream's time base: ``[floor(start/tb), ceil(end/tb)]``;
- a frame belongs to the window iff ``start_pts <= pts <= end_pts``;
- the last frame before ``start_pts`` is prepended when no frame lands
  exactly on it (reference :2362-2369);
- samples keep their native scale, then the channel mean, ``(T, 1)``
  float32 (reference :2182-2190).

PCM tracks (``sowt``/``twos``) are read in Python through ``io/mp4.py``, at
the granularity ffmpeg's mov demuxer packetizes PCM (one packet a chunk).
Every other codec (AAC, what real GoPro and Pupil recordings carry) goes
through the port's copy of the ffmpeg shim, ``csrc/audio.cpp``, built at
first use by ``io/native.py``; where it cannot be built or loaded (a host
without ffmpeg's libraries), such a read raises ``ImportError`` naming the
library before any decoding.
"""

import ctypes
import struct
from typing import Dict, Optional

import numpy as np

from routeformer_torch.io import native
from routeformer_torch.io.mp4 import MP4
from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.audio")

_EMPTY = {"audio": np.empty((0, 0), dtype=np.float32), "sample_rate": 0}
_PCM_CODECS = {"sowt": "<i2", "twos": ">i2"}


def _library() -> ctypes.CDLL:
    lib = native.library("audio")
    lib.rf_audio_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.rf_audio_decode.restype = ctypes.c_int
    lib.rf_audio_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.rf_audio_free.restype = None
    lib.rf_audio_encode_aac.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
    ]
    lib.rf_audio_encode_aac.restype = ctypes.c_int
    return lib


def _mono(frames: np.ndarray) -> np.ndarray:
    """(T, C) -> (T, 1) float32 channel mean."""
    return frames.astype(np.float32).mean(axis=1, keepdims=True)


def _audio_track(mp4: MP4):
    return next((t for t in mp4.tracks if t.handler == "soun"), None)


def read_audio(path, start_sec: float = 0.0,
               end_sec: float = float("inf")) -> Dict[str, object]:
    """Mono audio of ``[start, end]`` as ``{"audio": (T, 1) float32,
    "sample_rate": int}``; empty ``(0, 0)`` where nothing decodes (no audio
    track, an empty window), as the reference tolerates faults. A PCM track
    is read in Python, any other codec by the ffmpeg shim."""
    path = str(path)
    try:
        mp4 = MP4(path)
    except (OSError, ValueError) as e:
        logger.warning("could not open %s for audio: %s", path, e)
        return dict(_EMPTY)
    track = _audio_track(mp4)
    if track is None:
        logger.warning("no audio track in %s", path)
        return dict(_EMPTY)
    if track.codec in _PCM_CODECS:
        return _read_pcm(path, track, start_sec, end_sec)
    return _read_native(_library(), path, start_sec, end_sec)


def _read_native(lib, path: str, start_sec: float, end_sec: float):
    out = ctypes.POINTER(ctypes.c_float)()
    n, ch, rate = ctypes.c_longlong(), ctypes.c_int(), ctypes.c_int()
    rc = lib.rf_audio_decode(path.encode(), float(start_sec), float(end_sec),
                             ctypes.byref(out), ctypes.byref(n), ctypes.byref(ch),
                             ctypes.byref(rate))
    if rc != 0:
        logger.warning("no audio decoded from %s in [%s, %s) (rc=%d)",
                       path, start_sec, end_sec, rc)
        return dict(_EMPTY)
    try:
        frames = np.ctypeslib.as_array(out, shape=(int(n.value), int(ch.value))).copy()
    finally:
        lib.rf_audio_free(out)
    return {"audio": _mono(frames), "sample_rate": int(rate.value)}


def encode_aac(path, samples: np.ndarray, rate: int) -> None:
    """Write mono float32 ``samples`` as an AAC track in an MP4 (a
    recorder's role, for test recordings: real GoPro and Pupil recordings
    carry AAC). Raises ``ImportError`` where the ffmpeg shim cannot be
    built or loaded, ``RuntimeError`` where the encoder fails."""
    lib = _library()
    samples = np.ascontiguousarray(samples, dtype=np.float32).reshape(-1)
    rc = lib.rf_audio_encode_aac(str(path).encode(),
                                 samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 len(samples), int(rate))
    if rc != 0:
        raise RuntimeError(f"AAC encode of {path} failed (rc={rc})")


def _stsd_audio_fields(entry: bytes):
    """(channels, sample_size_bits, sample_rate) of a raw audio sample entry
    (size, codec, reserved, dref, then the v0 audio fields); ValueError on
    a truncated entry."""
    if len(entry) < 36:
        raise ValueError(f"truncated audio sample entry ({len(entry)} bytes)")
    channels, bits = struct.unpack(">HH", entry[24:28])
    rate = struct.unpack(">I", entry[32:36])[0] / 65536.0
    return channels, bits, rate


def _read_pcm(path: str, track, start_sec: float, end_sec: float):
    """The PCM twin: chunks selected by their first sample's pts, as
    ffmpeg's mov demuxer packetizes PCM (one packet a chunk)."""
    dtype = _PCM_CODECS[track.codec]
    try:
        channels, bits, _ = _stsd_audio_fields(track.stsd_entry)
    except ValueError as e:
        logger.warning("malformed audio sample entry in %s: %s", path, e)
        return dict(_EMPTY)
    if bits != 16 or channels < 1:
        raise RuntimeError(f"{path}: unsupported PCM layout ({bits}-bit, {channels}ch)")
    rate = track.timescale  # PCM in MP4: the media timescale is the sample rate
    if track.n_samples == 0 or not track.chunk_offsets:
        logger.warning("no audio samples in %s", path)
        return dict(_EMPTY)
    # (first sample index, file offset, frames) of every chunk, from stsc
    # and stco only: a real-length track has tens of millions of samples.
    chunks = []
    stsc = track.sample_to_chunk
    n_chunks = len(track.chunk_offsets)
    sample_idx = 0
    for entry_idx, (first_chunk, per_chunk) in enumerate(stsc):
        last_chunk = stsc[entry_idx + 1][0] - 1 if entry_idx + 1 < len(stsc) else n_chunks
        for chunk in range(first_chunk, last_chunk + 1):
            if sample_idx >= track.n_samples:
                break
            n = min(per_chunk, track.n_samples - sample_idx)
            chunks.append((sample_idx, track.chunk_offsets[chunk - 1], n))
            sample_idx += n

    start_pts = int(np.floor(start_sec * rate))
    end_pts = float("inf") if np.isinf(end_sec) else int(np.ceil(end_sec * rate))
    selected = []
    preceding: Optional[tuple] = None
    for c in chunks:
        if c[0] < start_pts:
            preceding = c
        elif c[0] <= end_pts:
            selected.append(c)
        else:
            break
    if preceding is not None and start_pts > 0 and not any(c[0] == start_pts
                                                           for c in selected):
        selected.insert(0, preceding)
    if not selected:
        logger.warning("no audio decoded from %s in [%s, %s)", path, start_sec, end_sec)
        return dict(_EMPTY)
    frame_bytes = 2 * channels
    parts = []
    with open(path, "rb") as f:
        for _, offset, n in selected:
            f.seek(offset)
            parts.append(np.frombuffer(f.read(n * frame_bytes), dtype=dtype)
                         .reshape(-1, channels))
    return {"audio": _mono(np.concatenate(parts, axis=0)), "sample_rate": int(rate)}
