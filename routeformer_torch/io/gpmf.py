"""GPMF (GoPro Metadata Format) parser and GPS track extraction
(counterpart of ``routeformer_tpu/io/gpmf.py``, the pure-Python walker).

Capability parity with the reference's GPMF pipeline
(``routeformer/io/dataset.py:2387-2646``), which shells out to ffmpeg for
the data track and parses it with the ``gopro2gpx`` package. Here the KLV
stream parser is implemented from the public GPMF spec
(https://github.com/gopro/gpmf-parser) and the MP4 data track is demuxed in
pure Python (``io/mp4.py``) — no ffmpeg subprocess, no gopro2gpx.

Preserved behaviors:

- SCAL/GPSU/GPSF/GPSP/GPS5 finite-state machine with per-batch GPSU
  timestamps (reference ``_build_gps_points`` :2387-2442);
- skipping all-zero GPS5 points; infinite dilution when GPSF=0
  (``_parse_gps5_stream`` :2444-2468);
- missing-timestamp reconstruction from the ~18 Hz GPS rate with the
  17.5-18.5 Hz plausibility window and the 18.17 Hz fallback
  (``_fix_timestamps``/``_estimate_fps`` :2480-2586);
- dilution-of-precision filtering (``_filter_points_by_dilution`` :2470).
"""

import datetime
import math
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.gpmf")

# GPMF type characters -> struct format (per element).
_TYPE_FMT = {
    ord("b"): "b",
    ord("B"): "B",
    ord("s"): "h",
    ord("S"): "H",
    ord("l"): "l",
    ord("L"): "L",
    ord("f"): "f",
    ord("d"): "d",
    ord("j"): "q",
    ord("J"): "Q",
    ord("q"): "l",  # Q15.16 fixed point
    ord("Q"): "q",  # Q31.32 fixed point
}


@dataclass
class KLVItem:
    """One GPMF key-length-value item."""

    fourcc: str
    type_char: str
    data: object


@dataclass
class GPSPoint:
    latitude: float
    longitude: float
    altitude: float
    time: Optional[datetime.datetime]
    speed: float


def _parse_payload(type_byte: int, struct_size: int, repeat: int, payload: bytes):
    if type_byte == ord("c"):
        return payload[: struct_size * repeat].decode("latin-1").rstrip("\x00")
    if type_byte == ord("U"):
        # UTC date string: "yymmddhhmmss.sss"
        text = payload[: struct_size * repeat].decode("latin-1").rstrip("\x00")
        try:
            return datetime.datetime.strptime(text, "%y%m%d%H%M%S.%f")
        except ValueError:
            return None
    if type_byte == ord("F"):
        return [
            payload[i * 4 : (i + 1) * 4].decode("latin-1") for i in range(repeat)
        ]
    fmt = _TYPE_FMT.get(type_byte)
    if fmt is None:
        return payload[: struct_size * repeat]  # opaque
    elem_size = struct.calcsize(">" + fmt)
    per_row = struct_size // elem_size
    rows = []
    for r in range(repeat):
        chunk = payload[r * struct_size : (r + 1) * struct_size]
        vals = struct.unpack(">" + fmt * per_row, chunk[: elem_size * per_row])
        if type_byte == ord("q"):
            vals = tuple(v / 2**16 for v in vals)
        elif type_byte == ord("Q"):
            vals = tuple(v / 2**32 for v in vals)
        rows.append(vals[0] if per_row == 1 else vals)
    return rows[0] if repeat == 1 and type_byte not in (ord("f"), ord("d")) else rows


def parse_gpmf(data: bytes) -> Iterator[KLVItem]:
    """Iterate GPMF KLV items, descending into nested containers (type 0).

    Robust on arbitrary bytes: malformed items trigger a 4-byte resync
    (GPMF streams concatenated per-sample can have slack), nesting is
    handled with an explicit work stack so hostile self-nested streams
    cannot blow the Python recursion limit.
    """
    # (buffer, pos) frames; containers push their payload as a new frame.
    stack: List[List] = [[data, 0]]
    while stack:
        frame = stack[-1]
        buf, pos = frame
        n = len(buf)
        if pos + 8 > n:
            stack.pop()
            continue
        fourcc = buf[pos : pos + 4].decode("latin-1", errors="replace")
        type_byte = buf[pos + 4]
        struct_size = buf[pos + 5]
        repeat = struct.unpack(">H", buf[pos + 6 : pos + 8])[0]
        length = struct_size * repeat
        padded = (length + 3) & ~3
        payload = buf[pos + 8 : pos + 8 + length]
        if not fourcc.isprintable() or len(payload) < length:
            frame[1] = pos + 4  # resync
            continue
        frame[1] = pos + 8 + padded
        if type_byte == 0:  # nested container
            stack.append([payload, 0])
        else:
            yield KLVItem(fourcc, chr(type_byte), _parse_payload(
                type_byte, struct_size, repeat, payload
            ))


def filter_dilution(points: List[GPSPoint], dilutions: List[float],
                    dilution_threshold: float) -> Tuple[List[GPSPoint], List[float]]:
    """The points (and their dilutions) below ``dilution_threshold``."""
    kept = [(p, d) for p, d in zip(points, dilutions) if d < dilution_threshold]
    return [p for p, _ in kept], [d for _, d in kept]


def build_gps_points(
    data: bytes, dilution_threshold: float = 500.0, prefer_native: bool = True
) -> Tuple[List[GPSPoint], List[float]]:
    """GPMF byte stream -> dilution-filtered, timestamped GPS points.

    FSM over SCAL/GPSU/GPSF/GPSP/GPS5 (reference dataset.py:2387-2442).
    ``prefer_native`` walks the stream with the C++ walker
    (``io/gpmf_native.py``), which gives the same points; a library that
    cannot be built or loaded raises ``ImportError``. ``prefer_native=False``
    asks for this Python walker, which also takes the streams the native
    walker calls non-canonical.
    """
    if prefer_native:
        from routeformer_torch.io.gpmf_native import build_gps_points_native

        result = build_gps_points_native(data, dilution_threshold)
        if result is not None:
            return result
    points: List[GPSPoint] = []
    dilutions: List[float] = []

    scal = (1.0, 1.0, 1.0, 1.0, 1.0)
    gpsu: Optional[datetime.datetime] = None
    gpsp: Optional[float] = None
    gpsfix = 0

    def _as_float(v) -> Optional[float]:
        """Numeric coercion that rejects (rather than raises on) the str /
        bytes / datetime payloads a malformed typed item can carry."""
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        return None

    for item in parse_gpmf(data):
        if item.fourcc == "SCAL":
            vals = item.data if isinstance(item.data, list) else [item.data]
            flat = []
            for v in vals:
                flat.extend(v if isinstance(v, tuple) else (v,))
            coerced = [_as_float(v) for v in flat]
            if coerced and all(c is not None for c in coerced):
                scal = tuple(coerced)
            else:
                logger.warning("Malformed SCAL item, keeping previous scale")
        elif item.fourcc == "GPSU":
            gpsu = item.data if isinstance(item.data, datetime.datetime) else None
        elif item.fourcc == "GPSF":
            val = item.data[0] if isinstance(item.data, list) else item.data
            fix = _as_float(val)
            gpsfix = int(fix) if fix is not None and math.isfinite(fix) else 0
        elif item.fourcc == "GPSP":
            val = item.data[0] if isinstance(item.data, list) else item.data
            gpsp = _as_float(val)
        elif item.fourcc == "GPS5":
            rows = item.data if isinstance(item.data, list) else [item.data]
            s0 = scal[0] if scal else 0.0
            s_lat = s0
            s_lon = scal[1] if len(scal) > 1 else s0
            s_alt = scal[2] if len(scal) > 2 else s0
            s_spd = scal[3] if len(scal) > 3 else s0
            if not all((s_lat, s_lon, s_alt, s_spd)):
                logger.warning("Zero/empty SCAL, skipping GPS5 batch")
                continue
            for row in rows:
                if not isinstance(row, tuple) or len(row) < 5:
                    continue
                lat_r, lon_r, alt_r, spd2d_r, _spd3d_r = row[:5]
                if lat_r == lon_r == alt_r == 0:
                    logger.warning("Empty GPS data point, skipping")
                    continue
                lat = float(lat_r) / s_lat
                lon = float(lon_r) / s_lon
                alt = float(alt_r) / s_alt
                spd = float(spd2d_r) / s_spd
                if not (math.isfinite(lat) and math.isfinite(lon)):
                    logger.warning("Non-finite GPS data point, skipping")
                    continue
                # GPSU stamps only the first point of each GPS5 batch.
                points.append(GPSPoint(lat, lon, alt, gpsu, spd))
                gpsu = None
                if gpsfix == 0:
                    dilutions.append(float("inf"))
                else:
                    dilutions.append(gpsp if gpsp is not None else float("inf"))

    fix_timestamps(points)
    filtered_points, filtered_dilutions = filter_dilution(points, dilutions,
                                                          dilution_threshold)
    logger.info("GPS data points: %d (OK: %d)", len(points), len(filtered_points))
    return filtered_points, filtered_dilutions


def estimate_fps(timestamps: List[Optional[datetime.datetime]]) -> List[float]:
    """Per-point FPS estimate with the reference's plausibility window
    (17.5-18.5 Hz) and 18.17 Hz fallback (dataset.py:2527-2586).

    Mutates ``timestamps``: implausible stamps are dropped (set None).
    """
    fps_list: List[float] = []
    last_ts_idx = None
    for ts_idx, ts in enumerate(timestamps):
        if ts is not None:
            if last_ts_idx is not None:
                count = ts_idx - last_ts_idx
                total = (ts - timestamps[last_ts_idx]).total_seconds()
                est = count / total if total != 0 else math.nan
                if math.isnan(est) or est > 18.5 or est < 17.5:
                    logger.warning(
                        "Implausible fps %.3f between %s and %s; dropping stamp",
                        est, timestamps[last_ts_idx], ts,
                    )
                    timestamps[last_ts_idx] = None
                    fps_list.append(math.nan)
                else:
                    fps_list.append(est)
            else:
                fps_list.append(math.nan)
            last_ts_idx = ts_idx
        else:
            fps_list.append(math.nan)

    last_valid = None
    for fps in reversed(fps_list):
        if not math.isnan(fps):
            last_valid = fps
            break
    if last_valid is None:
        last_valid = 18.17  # GPMF default GPS rate
    for i in range(len(fps_list) - 1, -1, -1):
        if math.isnan(fps_list[i]):
            fps_list[i] = last_valid
        else:
            last_valid = fps_list[i]
    return fps_list


def fix_timestamps(points: List[GPSPoint]) -> List[GPSPoint]:
    """Interpolate missing per-point timestamps from batch GPSU stamps
    (reference dataset.py:2480-2525)."""
    timestamps = [p.time for p in points]
    fps_list = estimate_fps(timestamps)

    last_valid = None
    for i, ts in enumerate(timestamps):
        if ts is not None:
            last_valid = i
        elif last_valid is not None:
            timestamps[i] = timestamps[last_valid] + datetime.timedelta(
                seconds=(i - last_valid) / fps_list[i]
            )

    first_valid = None
    for i, ts in enumerate(timestamps):
        if ts is not None:
            first_valid = i
            break
    if first_valid is None:
        logger.warning("No valid timestamps found")
        return points
    for i in range(first_valid):
        timestamps[i] = timestamps[first_valid] - datetime.timedelta(
            seconds=(first_valid - i) / fps_list[i]
        )

    for i, ts in enumerate(timestamps):
        points[i].time = ts
    return points


def encode_gpmf(items: List[Tuple[str, str, bytes, int, int]]) -> bytes:
    """Encode raw KLV items (fourcc, type_char, payload, struct_size, repeat)
    — used by tests to build byte fixtures."""
    out = bytearray()
    for fourcc, type_char, payload, struct_size, repeat in items:
        out += fourcc.encode("latin-1")
        out += bytes([0 if type_char == "\x00" else ord(type_char)])
        out += bytes([struct_size])
        out += struct.pack(">H", repeat)
        padded = (len(payload) + 3) & ~3
        out += payload + b"\x00" * (padded - len(payload))
    return bytes(out)
