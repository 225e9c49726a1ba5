"""A GEM recording written from a seed, with no JAX, cv2 or msgpack: test
support for the data path, not a user feature (counterpart of the JAX
package's ``tests/gem_fixture.py``, which imports ``routeformer_tpu`` and
encodes its videos with cv2).

``build_gem_fixture`` writes one subject in the GEM layout that
``io/dataset.GEMDataset`` reads, with every clock aligned as the JAX
fixture aligns them: the GoPro pair as uncompressed ``'raw '`` RGB24 MP4s
beside a GPMF ``gpmd`` track that carries the trajectory (the GPS clock
starts at ``T0``), the eye tracker's ``world.mp4`` (also raw, lagging the
gaze clock by 0.35 s, so it sets the common origin), its timestamps,
intrinsics, ``gaze.pldata`` at 200 Hz and info files, and the corrected
GPS as a 2 Hz CSV. Frame ``i`` of a video is a seeded uint8 noise image
rolled ``i`` pixels along its width, so distinct source frames stay
distinct after any undistort, crop and resize. ``turn`` adds a slow
weave to the heading, so that windows pass a PCI filter. ``with_audio``
adds a 16-bit PCM (``sowt``) track to the three videos, as the JAX
fixture's ``inject_pcm_audio_track`` does (1024 frames a chunk, the seeded
tones of ``audio_tone``).
"""

import datetime
import json
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from routeformer_torch.io.file_methods import save_object, save_pldata_file
from routeformer_torch.io.gpmf import encode_gpmf
from routeformer_torch.io.resample import inverse_gps_coordinates

T0 = 1_630_000_000.0  # epoch origin of every clock
GPS_HZ = 18
VIDEO_FPS = 30.0
GAZE_HZ = 200
WORLD_LAG_S = 0.35


def make_trajectory(duration_s: float, seed: int = 0, turn: float = 0.0,
                    turn_period_s: float = 16.0) -> np.ndarray:
    """Smooth driving trajectory in web-mercator meters at ``GPS_HZ``: the
    JAX fixture's random walk of the heading, plus ``turn`` radians of
    sinusoidal weave."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * GPS_HZ)
    heading = np.cumsum(rng.normal(0, 0.02, n)) + rng.uniform(0, 2 * np.pi)
    heading += turn * np.sin(2 * np.pi * np.arange(n) / (GPS_HZ * turn_period_s))
    speed = np.clip(8 + np.cumsum(rng.normal(0, 0.05, n)), 2, 20) / GPS_HZ
    vel = np.stack([np.cos(heading), np.sin(heading)], -1) * speed[:, None]
    return np.array([900000.0, 5000000.0]) + np.cumsum(vel, axis=0)


def gpmf_stream(xy_m: np.ndarray, start_epoch: float) -> bytes:
    """A trajectory as GPMF: SCAL/GPSF/GPSP, then one GPSU stamp and one
    GPS5 batch per second."""
    latlon = inverse_gps_coordinates(xy_m)
    items = [
        ("SCAL", "l", struct.pack(">lllll", 10000000, 10000000, 1000, 1000, 100), 4, 5),
        ("GPSF", "L", struct.pack(">L", 3), 4, 1),
        ("GPSP", "S", struct.pack(">H", 150), 2, 1),
    ]
    for batch_start in range(0, len(latlon), GPS_HZ):
        t = start_epoch + batch_start / GPS_HZ
        stamp = datetime.datetime.fromtimestamp(
            t, datetime.timezone.utc).strftime("%y%m%d%H%M%S.%f")[:16]
        items.append(("GPSU", "U", stamp.encode(), 16, 1))
        batch = latlon[batch_start: batch_start + GPS_HZ]
        rows = b"".join(struct.pack(">lllll", int(lat * 1e7), int(lon * 1e7), 400 * 1000,
                                    5 * 1000, 5 * 100) for lat, lon in batch)
        items.append(("GPS5", "l", rows, 20, len(batch)))
    return encode_gpmf(items)


def _box(btype: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + btype + body


def _full(btype: bytes, version_flags: int, body: bytes) -> bytes:
    return _box(btype, struct.pack(">I", version_flags) + body)


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _video_trak(hw: Tuple[int, int], fps: float, n: int, frame_bytes: int,
                first_offset: int) -> bytes:
    h, w = hw
    timescale, delta = int(round(fps * 1000)), 1000
    tkhd = _full(b"tkhd", 7, struct.pack(">IIIII", 0, 0, 1, 0, n * 1000 // int(round(fps)))
                 + b"\x00" * 8 + struct.pack(">hhhH", 0, 0, 0, 0) + _MATRIX
                 + struct.pack(">II", w << 16, h << 16))
    mdhd = _full(b"mdhd", 0, struct.pack(">IIIIHH", 0, 0, timescale, n * delta, 0x55C4, 0))
    hdlr = _full(b"hdlr", 0, b"\x00" * 4 + b"vide" + b"\x00" * 12 + b"VideoHandler\x00")
    entry = (b"\x00" * 6 + struct.pack(">H", 1) + b"\x00" * 16 + struct.pack(">HH", w, h)
             + struct.pack(">III", 0x480000, 0x480000, 0) + struct.pack(">H", 1)
             + b"\x00" * 32 + struct.pack(">Hh", 24, -1))
    stsd = _full(b"stsd", 0, struct.pack(">I", 1) + _box(b"raw ", entry))
    stts = _full(b"stts", 0, struct.pack(">III", 1, n, delta))
    stsc = _full(b"stsc", 0, struct.pack(">IIII", 1, 1, 1, 1))
    stsz = _full(b"stsz", 0, struct.pack(">II", frame_bytes, n))
    offsets = [first_offset + i * frame_bytes for i in range(n)]
    if offsets and offsets[-1] >= 2 ** 32:
        stco = _full(b"co64", 0, struct.pack(f">I{n}Q", n, *offsets))
    else:
        stco = _full(b"stco", 0, struct.pack(f">I{n}I", n, *offsets))
    vmhd = _full(b"vmhd", 1, b"\x00" * 8)
    dinf = _box(b"dinf", _full(b"dref", 0, struct.pack(">I", 1) + _full(b"url ", 1, b"")))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
    mdia = _box(b"mdia", mdhd + hdlr + _box(b"minf", vmhd + dinf + stbl))
    return _box(b"trak", tkhd + mdia)


def _gpmd_trak(payload_offset: int, size: int) -> bytes:
    """The telemetry track of ``tests/gem_fixture.py:inject_gpmf_track``:
    one ``gpmd`` sample holding the whole GPMF stream."""
    tkhd = _full(b"tkhd", 7, struct.pack(">III", 0, 0, 99) + b"\x00" * 60
                 + struct.pack(">II", 0, 0))
    mdhd = _full(b"mdhd", 0, struct.pack(">IIII", 0, 0, 1000, 1000) + b"\x00" * 4)
    hdlr = _full(b"hdlr", 0, b"\x00" * 4 + b"meta" + b"\x00" * 12 + b"GoPro MET\x00")
    stsd = _full(b"stsd", 0, struct.pack(">I", 1) + _box(b"gpmd", b"\x00" * 8))
    stsz = _full(b"stsz", 0, struct.pack(">III", 0, 1, size))
    stco = _full(b"stco", 0, struct.pack(">II", 1, payload_offset))
    stsc = _full(b"stsc", 0, struct.pack(">IIII", 1, 1, 1, 1))
    stts = _full(b"stts", 0, struct.pack(">III", 1, 1, 1000))
    stbl = _box(b"stbl", stsd + stsz + stco + stsc + stts)
    return _box(b"trak", tkhd + _box(b"mdia", mdhd + hdlr + _box(b"minf", stbl)))


def audio_tone(duration_s: float, rate: int, seed: int = 0) -> np.ndarray:
    """Stereo int16 PCM: a tone per channel plus seeded noise, so that
    window slicing and the channel mean both show."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * rate)) / rate
    pcm = np.stack([12000 * np.sin(2 * np.pi * 440.0 * t),
                    9000 * np.sin(2 * np.pi * 660.0 * t)], axis=1)
    pcm += rng.normal(0, 150, size=pcm.shape)
    return np.clip(pcm, -32768, 32767).astype(np.int16)


def _pcm_trak(n: int, channels: int, rate: int, chunk_offsets, frames_per_chunk: int) -> bytes:
    """The JAX fixture's ``sowt`` track: v0 AudioSampleEntry, one sample a
    PCM frame, ``frames_per_chunk`` frames a chunk."""
    n_chunks = len(chunk_offsets)
    tkhd = _full(b"tkhd", 7, struct.pack(">III", 0, 0, 98) + b"\x00" * 60
                 + struct.pack(">II", 0, 0))
    mdhd = _full(b"mdhd", 0, struct.pack(">IIII", 0, 0, rate, n) + b"\x00" * 4)
    hdlr = _full(b"hdlr", 0, b"\x00" * 4 + b"soun" + b"\x00" * 12 + b"Audio\x00")
    entry = (b"\x00" * 6 + struct.pack(">H", 1)
             + struct.pack(">HHIHHHH", 0, 0, 0, channels, 16, 0, 0)
             + struct.pack(">I", rate << 16))
    stsd = _full(b"stsd", 0, struct.pack(">I", 1) + _box(b"sowt", entry))
    stsz = _full(b"stsz", 0, struct.pack(">II", 2 * channels, n))
    if chunk_offsets[-1] >= 2 ** 32:
        stco = _full(b"co64", 0, struct.pack(f">I{n_chunks}Q", n_chunks, *chunk_offsets))
    else:
        stco = _full(b"stco", 0, struct.pack(f">I{n_chunks}I", n_chunks, *chunk_offsets))
    last_per = n - (n_chunks - 1) * frames_per_chunk
    if n_chunks > 1 and last_per != frames_per_chunk:
        stsc_body = struct.pack(">IIIIIII", 2, 1, frames_per_chunk, 1, n_chunks, last_per, 1)
    else:
        stsc_body = struct.pack(">IIII", 1, 1, min(frames_per_chunk, n), 1)
    stsc = _full(b"stsc", 0, stsc_body)
    stts = _full(b"stts", 0, struct.pack(">III", 1, n, 1))
    stbl = _box(b"stbl", stsd + stsz + stco + stsc + stts)
    minf = _box(b"minf", _full(b"smhd", 0, b"\x00" * 4) + stbl)
    return _box(b"trak", tkhd + _box(b"mdia", mdhd + hdlr + minf))


def inject_pcm_audio_track(path: Path, pcm: np.ndarray, rate: int,
                           frames_per_chunk: int = 1024) -> None:
    """Add a 16-bit little-endian PCM (``sowt``) track to an MP4 in place:
    the ``moov`` box becomes ``free``, and the PCM as a new ``mdat`` and a
    ``moov`` holding the old one's boxes and the audio track follow it.
    Only box headers and the ``moov`` are read, so a large video is cheap."""
    if pcm.dtype != np.int16 or pcm.ndim != 2:
        raise ValueError("pcm must be (frames, channels) int16")
    n, channels = pcm.shape
    with open(path, "r+b") as f:
        size_all = f.seek(0, 2)
        pos = 0
        while pos + 8 <= size_all:
            f.seek(pos)
            size, btype = struct.unpack(">I4s", f.read(8))
            header = 8
            if size == 1:
                size, header = struct.unpack(">Q", f.read(8))[0], 16
            elif size == 0:
                size = size_all - pos
            if btype == b"moov":
                break
            pos += size
        else:
            raise ValueError(f"{path}: no moov box")
        f.seek(pos + header)
        moov_body = f.read(size - header)
        f.seek(pos + 4)
        f.write(b"free")
        payload_offset = size_all + 8
        offsets = [payload_offset + i * frames_per_chunk * 2 * channels
                   for i in range(-(-n // frames_per_chunk))]
        f.seek(size_all)
        f.write(struct.pack(">I", 8 + n * 2 * channels) + b"mdat")
        f.write(pcm.astype("<i2").tobytes())
        f.write(_box(b"moov", moov_body + _pcm_trak(n, channels, rate, offsets,
                                                    frames_per_chunk)))


def video_frame(base: np.ndarray, i: int) -> np.ndarray:
    """Frame ``i`` of a fixture video: ``base`` rolled ``i`` pixels."""
    return np.roll(base, shift=i, axis=1)


def video_base(hw: Tuple[int, int], seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 255, size=(hw[0], hw[1], 3),
                                                dtype=np.uint8)


def write_raw_video(path: Path, n_frames: int, hw=(48, 64), seed: int = 0,
                    fps: float = VIDEO_FPS, gpmf: Optional[bytes] = None) -> None:
    """An MP4 of ``n_frames`` uncompressed RGB24 frames (``video_frame``
    of a seeded base), with a ``gpmd`` track when ``gpmf`` is given."""
    base = video_base(hw, seed)
    frame_bytes = hw[0] * hw[1] * 3
    payload = n_frames * frame_bytes + len(gpmf or b"")
    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso2mp41")
    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(struct.pack(">I", 1) + b"mdat" + struct.pack(">Q", 16 + payload))
        first = len(ftyp) + 16
        for i in range(n_frames):
            f.write(video_frame(base, i).tobytes())
        traks = _video_trak(hw, fps, n_frames, frame_bytes, first)
        if gpmf is not None:
            f.write(gpmf)
            traks += _gpmd_trak(first + n_frames * frame_bytes, len(gpmf))
        duration_ms = int(n_frames * 1000 / fps)
        mvhd = _full(b"mvhd", 0, struct.pack(">IIIIIH", 0, 0, 1000, duration_ms, 0x10000,
                                             0x100) + b"\x00" * 10 + _MATRIX
                     + b"\x00" * 24 + struct.pack(">I", 100))
        f.write(_box(b"moov", mvhd + traks))


def build_gem_fixture(root, duration_s: float = 20.0, subject: str = "001", hw=(48, 64),
                      world_hw: Optional[Tuple[int, int]] = None, fps: float = VIDEO_FPS,
                      seed: int = 0, turn: float = 0.0, with_audio: bool = False,
                      audio_rate: int = 48000) -> dict:
    """Write one subject of a GEM recording under ``root`` (module
    docstring). ``hw`` sizes the GoPro frames and ``world_hw`` (default
    ``hw``) the eye tracker's; ``fps`` is every video's rate; ``seed``
    draws the trajectory and, offset per video, the frames; ``with_audio``
    adds PCM tracks at ``audio_rate`` (tones seeded 11, 12, 13 for the
    left, right and world videos, as the JAX fixture's)."""
    root = Path(root)
    world_hw = hw if world_hw is None else world_hw
    gopro = root / "01GoPro" / subject
    eye = root / "02EyeTracker" / subject
    gps_dir = root / "03CorrectedGPS" / subject
    for d in (gopro / "left", gopro / "right", eye, gps_dir):
        d.mkdir(parents=True, exist_ok=True)

    traj = make_trajectory(duration_s, seed=seed, turn=turn)
    n_frames = int(duration_s * fps)
    payload = gpmf_stream(traj, T0)
    write_raw_video(gopro / "left" / "GH010008.MP4", n_frames, hw, seed + 1, fps, payload)
    write_raw_video(gopro / "right" / "GH010009.MP4", n_frames, hw, seed + 2, fps, payload)
    if with_audio:
        for name, tone in (("left/GH010008.MP4", 11), ("right/GH010009.MP4", 12)):
            inject_pcm_audio_track(gopro / name, audio_tone(duration_s, audio_rate, tone),
                                   audio_rate)

    # Pupil timestamps are relative; the posix anchor is start_time_gaze
    # (= T0), which the reader adds.
    gaze_ts = np.arange(int(duration_s * GAZE_HZ)) / GAZE_HZ
    rng = np.random.default_rng(seed + 3)
    gaze_entries = [
        {"topic": "gaze.pi",
         "norm_pos": (float(0.5 + 0.02 * np.sin(i / 50) + rng.normal(0, 0.001)),
                      float(0.5 + 0.02 * np.cos(i / 70) + rng.normal(0, 0.001))),
         "timestamp": float(ts), "confidence": 0.99}
        for i, ts in enumerate(gaze_ts)]
    save_pldata_file(gaze_entries, gaze_ts, eye, "gaze")

    write_raw_video(eye / "world.mp4", n_frames, world_hw, seed + 4, fps)
    if with_audio:
        inject_pcm_audio_track(eye / "world.mp4", audio_tone(duration_s, audio_rate, 13),
                               audio_rate)
    np.save(eye / "world_timestamps.npy", WORLD_LAG_S + np.arange(n_frames) / fps)
    save_object({"(1088, 1080)": {
        "cam_type": "radial",
        "camera_matrix": [[766.0, 0.0, 544.0], [0.0, 766.0, 540.0], [0.0, 0.0, 1.0]],
        "dist_coefs": [[-0.1, 0.05, 0.0, 0.0, 0.0]]}}, eye / "world.intrinsics")
    start_ns = int(T0 * 1e9)
    (eye / "info.invisible.json").write_text(
        json.dumps({"start_time": start_ns, "duration": int(duration_s * 1e9)}))
    (eye / "info.player.json").write_text(
        json.dumps({"start_time_synced_s": start_ns / 1e9, "duration_s": duration_s}))

    # corrected GPS: the trajectory at 2 Hz on the left video's clock
    latlon = inverse_gps_coordinates(traj)
    step = GPS_HZ // 2
    ms = (np.arange(len(latlon)) / GPS_HZ * 1000.0)[::step]
    (gps_dir / "GH010008_1.csv").write_text("\n".join(
        f"{lat:.8f},{lon:.8f},{int(m)}" for (lat, lon), m in zip(latlon[::step], ms)))
    return {"traj": traj, "duration": duration_s, "n_frames": n_frames}
