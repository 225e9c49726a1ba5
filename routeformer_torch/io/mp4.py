"""Minimal pure-Python MP4 (ISO BMFF) demuxer (counterpart of
``routeformer_tpu/io/mp4.py``).

Parses ``moov`` (mvhd/trak/mdia/hdlr/stbl) and resolves each track's sample
table (stsc/stsz/stco|co64) to file offsets, so any track's samples can be
read by seeking: GoPro's ``gpmd`` telemetry track, and the frames of an
uncompressed video track. The port adds the video sample entry's fields
(``Track.visual``: width, height and bit depth of the first
``VisualSampleEntry``), which is all a reader of ``'raw '`` RGB24 video
needs to turn a sample into a frame without a codec library
(``io/video.py``).
"""

import datetime
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.mp4")

_CONTAINERS = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"udta", b"dinf",
}

# MP4 epoch: 1904-01-01 (seconds).
_MP4_EPOCH = datetime.datetime(1904, 1, 1, tzinfo=datetime.timezone.utc)


@dataclass
class Track:
    track_id: int = 0
    handler: str = ""
    handler_name: str = ""
    codec: str = ""
    timescale: int = 0
    duration: int = 0
    sample_sizes: List[int] = field(default_factory=list)
    chunk_offsets: List[int] = field(default_factory=list)
    # stsc entries: (first_chunk, samples_per_chunk)
    sample_to_chunk: List[Tuple[int, int]] = field(default_factory=list)
    # stts entries: (count, delta)
    time_deltas: List[Tuple[int, int]] = field(default_factory=list)
    width: float = 0.0
    height: float = 0.0
    # raw bytes of the first stsd sample entry (codec-specific fields, e.g.
    # audio channel count / sample size — parsed by io/audio.py)
    stsd_entry: bytes = b""

    @property
    def visual(self) -> Optional[Tuple[int, int, int]]:
        """``(width, height, depth)`` of a video track's first
        ``VisualSampleEntry`` (ISO 14496-12 §12.1.3), or None when the
        entry is too short to be one."""
        entry = self.stsd_entry
        if self.handler != "vide" or len(entry) < 86:
            return None
        width, height = struct.unpack(">HH", entry[32:36])
        (depth,) = struct.unpack(">H", entry[82:84])
        return width, height, depth

    @property
    def n_samples(self) -> int:
        return len(self.sample_sizes)

    @property
    def duration_seconds(self) -> float:
        return self.duration / self.timescale if self.timescale else 0.0

    @property
    def fps(self) -> float:
        """Average sample rate from the media duration."""
        secs = self.duration_seconds
        return self.n_samples / secs if secs > 0 else 0.0

    def sample_times(self) -> List[float]:
        """Start time (s) of every sample, from stts."""
        times = []
        t = 0
        for count, delta in self.time_deltas:
            for _ in range(count):
                times.append(t / self.timescale if self.timescale else 0.0)
                t += delta
        return times

    def sample_offsets(self) -> List[Tuple[int, int]]:
        """Resolve (file_offset, size) for every sample via stsc/stco/stsz."""
        out = []
        if not self.chunk_offsets:
            return out
        stsc = self.sample_to_chunk
        n_chunks = len(self.chunk_offsets)
        sample_idx = 0
        for entry_idx, (first_chunk, per_chunk) in enumerate(stsc):
            last_chunk = (
                stsc[entry_idx + 1][0] - 1 if entry_idx + 1 < len(stsc) else n_chunks
            )
            for chunk in range(first_chunk, last_chunk + 1):
                offset = self.chunk_offsets[chunk - 1]
                for _ in range(per_chunk):
                    if sample_idx >= len(self.sample_sizes):
                        return out
                    size = self.sample_sizes[sample_idx]
                    out.append((offset, size))
                    offset += size
                    sample_idx += 1
        return out


class MP4(object):
    """Parsed MP4 container: movie header + per-track sample tables."""

    def __init__(self, path):
        self.path = Path(path)
        self.timescale = 0
        self.duration = 0
        self.creation_time: Optional[datetime.datetime] = None
        self.tracks: List[Track] = []
        self._parse()

    # ------------------------------------------------------------------ #

    def _parse(self):
        with open(self.path, "rb") as f:
            data = f.read(16)
            f.seek(0, 2)
            file_size = f.tell()
            f.seek(0)
            pos = 0
            moov = None
            while pos + 8 <= file_size:
                f.seek(pos)
                header = f.read(16)
                if len(header) < 8:
                    break
                size = struct.unpack(">I", header[:4])[0]
                box_type = header[4:8]
                body_start = pos + 8
                if size == 1:  # 64-bit size
                    if len(header) < 16:
                        break
                    size = struct.unpack(">Q", header[8:16])[0]
                    body_start = pos + 16
                elif size == 0:
                    size = file_size - pos
                if box_type == b"moov":
                    f.seek(body_start)
                    moov = f.read(pos + size - body_start)
                    break
                pos += size
            del data
        if moov is None:
            raise ValueError(f"{self.path}: no moov box found")
        try:
            self._parse_moov(moov)
        except (struct.error, IndexError, OverflowError, UnicodeDecodeError) as e:
            # Robustness contract: malformed metadata surfaces as ValueError,
            # never as a raw struct/index error (tests/test_parser_robustness).
            raise ValueError(f"{self.path}: malformed mp4 metadata: {e}") from e

    def _iter_boxes(self, buf: bytes, start: int, end: int):
        pos = start
        while pos + 8 <= end:
            size = struct.unpack(">I", buf[pos : pos + 4])[0]
            box_type = buf[pos + 4 : pos + 8]
            body = pos + 8
            if size == 1:
                if pos + 16 > end:
                    return  # truncated 64-bit size header
                size = struct.unpack(">Q", buf[pos + 8 : pos + 16])[0]
                body = pos + 16
            elif size == 0:
                size = end - pos
            yield box_type, body, min(pos + size, end)
            pos += max(size, 8)

    def _parse_moov(self, moov: bytes):
        for box_type, body, box_end in self._iter_boxes(moov, 0, len(moov)):
            if box_type == b"mvhd":
                version = moov[body]
                if version == 1:
                    ct, _, ts, dur = struct.unpack(
                        ">QQIQ", moov[body + 4 : body + 32]
                    )
                else:
                    ct, _, ts, dur = struct.unpack(
                        ">IIII", moov[body + 4 : body + 20]
                    )
                self.timescale = ts
                self.duration = dur
                if ct:
                    self.creation_time = _MP4_EPOCH + datetime.timedelta(seconds=ct)
            elif box_type == b"trak":
                self.tracks.append(self._parse_trak(moov, body, box_end))

    def _parse_trak(self, buf: bytes, start: int, end: int) -> Track:
        track = Track()

        def walk(s, e):
            for box_type, body, box_end in self._iter_boxes(buf, s, e):
                if box_type == b"tkhd":
                    version = buf[body]
                    if version == 1:
                        track.track_id = struct.unpack(
                            ">I", buf[body + 20 : body + 24]
                        )[0]
                    else:
                        track.track_id = struct.unpack(
                            ">I", buf[body + 12 : body + 16]
                        )[0]
                    # width/height: last 8 bytes, 16.16 fixed point
                    w, h = struct.unpack(">II", buf[box_end - 8 : box_end])
                    track.width = w / 65536.0
                    track.height = h / 65536.0
                elif box_type == b"mdhd":
                    version = buf[body]
                    if version == 1:
                        ts, dur = struct.unpack(">IQ", buf[body + 20 : body + 32])
                    else:
                        ts, dur = struct.unpack(">II", buf[body + 12 : body + 20])
                    track.timescale = ts
                    track.duration = dur
                elif box_type == b"hdlr":
                    track.handler = buf[body + 8 : body + 12].decode(
                        "latin-1", errors="replace"
                    )
                    name = buf[body + 24 : box_end]
                    track.handler_name = name.split(b"\x00")[0].decode(
                        "latin-1", errors="replace"
                    )
                elif box_type == b"stsd":
                    count = struct.unpack(">I", buf[body + 4 : body + 8])[0]
                    if count > 0:
                        track.codec = buf[body + 12 : body + 16].decode(
                            "latin-1", errors="replace"
                        )
                        entry_size = struct.unpack(
                            ">I", buf[body + 8 : body + 12]
                        )[0]
                        track.stsd_entry = bytes(
                            buf[body + 8 : body + 8 + entry_size]
                        )
                elif box_type == b"stsz":
                    uniform, count = struct.unpack(">II", buf[body + 4 : body + 12])
                    if uniform:
                        track.sample_sizes = [uniform] * count
                    else:
                        track.sample_sizes = list(
                            struct.unpack(
                                f">{count}I", buf[body + 12 : body + 12 + 4 * count]
                            )
                        )
                elif box_type == b"stco":
                    count = struct.unpack(">I", buf[body + 4 : body + 8])[0]
                    track.chunk_offsets = list(
                        struct.unpack(
                            f">{count}I", buf[body + 8 : body + 8 + 4 * count]
                        )
                    )
                elif box_type == b"co64":
                    count = struct.unpack(">I", buf[body + 4 : body + 8])[0]
                    track.chunk_offsets = list(
                        struct.unpack(
                            f">{count}Q", buf[body + 8 : body + 8 + 8 * count]
                        )
                    )
                elif box_type == b"stsc":
                    count = struct.unpack(">I", buf[body + 4 : body + 8])[0]
                    entries = []
                    for i in range(count):
                        off = body + 8 + 12 * i
                        first, per, _ = struct.unpack(">III", buf[off : off + 12])
                        entries.append((first, per))
                    track.sample_to_chunk = entries
                elif box_type == b"stts":
                    count = struct.unpack(">I", buf[body + 4 : body + 8])[0]
                    entries = []
                    for i in range(count):
                        off = body + 8 + 8 * i
                        c, d = struct.unpack(">II", buf[off : off + 8])
                        entries.append((c, d))
                    track.time_deltas = entries
                elif box_type in _CONTAINERS:
                    walk(body, box_end)

        walk(start, end)
        return track

    # ------------------------------------------------------------------ #

    def data_tracks(self) -> List[Track]:
        """Tracks ffmpeg would map as ``0:d:N`` (GoPro telemetry is 'meta')."""
        return [t for t in self.tracks if t.handler == "meta"]

    def gpmd_track(self) -> Optional[Track]:
        for t in self.data_tracks():
            if t.codec == "gpmd" or "GoPro MET" in t.handler_name:
                return t
        return None

    def video_track(self) -> Optional[Track]:
        for t in self.tracks:
            if t.handler == "vide":
                return t
        return None

    def read_track(
        self, track: Track, start_sec: float = 0.0, end_sec: float = float("inf")
    ) -> bytes:
        """Concatenated sample bytes of a track within [start_sec, end_sec]
        (the ffmpeg ``-codec copy -f rawvideo`` equivalent)."""
        offsets = track.sample_offsets()
        times = track.sample_times()
        if len(times) < len(offsets):
            times += [float("inf")] * (len(offsets) - len(times))

        out = bytearray()
        with open(self.path, "rb") as f:
            for (offset, size), ts in zip(offsets, times):
                if ts < start_sec or ts > end_sec:
                    continue
                f.seek(offset)
                out += f.read(size)
        return bytes(out)


def read_gpmf_data(path, start_sec: float = 0.0, end_sec: float = float("inf")) -> bytes:
    """GPMF byte stream of a GoPro MP4 (reference ``_read_data_track`` role)."""
    mp4 = MP4(path)
    track = mp4.gpmd_track()
    if track is None:
        raise ValueError(f"{path}: no GPMF (gpmd) data track")
    return mp4.read_track(track, start_sec, end_sec)
