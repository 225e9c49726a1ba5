"""Frame files and uncompressed AVI, read by their content.

DR(eye)VE sessions hold their frames as ``video_*_frames/{:06d}.jpg`` or as
``video_*.avi``; the JAX package reads both through cv2 (``cv2.imread``,
``cv2.VideoCapture``). cv2 decodes an image by its content, not by its
name, so the port does the same, with numpy for the formats that need no
decoder and cv2 only for the rest:

- a 24-bit ``BI_RGB`` BMP (bottom-up or top-down, rows padded to 4 bytes)
  and a binary PPM (``P6``, maxval 255) are read here, bit for bit as
  ``cv2.imread`` reads them;
- an AVI whose video stream is uncompressed 24-bit ``BI_RGB``
  (``AviReader``) is read here by chunk offset;
- anything else (JPEG: every real DR(eye)VE frame; a compressed AVI) goes
  through cv2 where it can be imported, and raises ``ImportError`` naming
  the file and cv2 where it cannot.

Every reader returns RGB uint8 (H, W, 3). ``write_bmp`` and ``write_avi``
write the formats read here (for fixtures and for frames exploded on a
host without cv2).
"""

import itertools
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

BMP, PPM, OTHER = "bmp", "ppm", "other"
_HEAD_BYTES = 64


def _cv2(path, what: str):
    """cv2, or ``ImportError`` naming ``path`` and why it needs cv2."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"{path}: {what} needs cv2, which cannot be imported here. Convert the "
            "frames to 24-bit BMP or binary PPM (the port reads both without cv2), or "
            "build the dataset's sample cache (use_cache=True) on a host with cv2") from e
    return cv2


def _bmp_geometry(head: bytes) -> Optional[Tuple[int, int, int, bool]]:
    """``(data offset, width, height, top_down)`` of a 24-bit uncompressed
    BMP, else None."""
    if len(head) < 54 or head[:2] != b"BM":
        return None
    offset, = struct.unpack_from("<I", head, 10)
    header_size, width, height, planes, bits, compression = struct.unpack_from(
        "<IiiHHI", head, 14)
    if header_size < 40 or planes != 1 or bits != 24 or compression != 0 or width <= 0:
        return None
    return offset, width, abs(height), height < 0


def _ppm_geometry(data: bytes) -> Optional[Tuple[int, int, int]]:
    """``(data offset, width, height)`` of a binary PPM with maxval 255,
    else None. The header is four whitespace-separated tokens (comments
    from ``#`` to the line's end), then one whitespace byte."""
    if data[:2] != b"P6":
        return None
    tokens, pos = [], 2
    while len(tokens) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace() and data[pos:pos + 1] != b"#":
            pos += 1
        if start == pos:
            return None
        tokens.append(data[start:pos])
    if not all(t.isdigit() for t in tokens) or int(tokens[2]) != 255:
        return None
    return pos + 1, int(tokens[0]), int(tokens[1])


def frame_format(path) -> str:
    """``BMP`` or ``PPM`` when the file's content is one this module reads,
    else ``OTHER``."""
    with open(path, "rb") as f:
        head = f.read(_HEAD_BYTES)
    if _bmp_geometry(head) is not None:
        return BMP
    if head[:2] == b"P6":
        with open(path, "rb") as f:
            head = f.read(4096)
        if _ppm_geometry(head) is not None:
            return PPM
    return OTHER


def require_frame_decoder(path) -> None:
    """Raise now the ``ImportError`` that reading ``path`` would raise."""
    if frame_format(path) == OTHER:
        _cv2(path, "its image format")


def _bgr_rows(data: bytes, offset: int, width: int, height: int, stride: int) -> np.ndarray:
    rows = np.frombuffer(data, np.uint8, count=stride * height, offset=offset)
    return rows.reshape(height, stride)[:, : width * 3].reshape(height, width, 3)


def decode_frame(data: bytes, path="<bytes>") -> np.ndarray:
    """One image file's bytes -> RGB uint8 (H, W, 3)."""
    geometry = _bmp_geometry(data[:_HEAD_BYTES])
    if geometry is not None:
        offset, width, height, top_down = geometry
        bgr = _bgr_rows(data, offset, width, height, (width * 3 + 3) & ~3)
        return np.ascontiguousarray((bgr if top_down else bgr[::-1])[..., ::-1])
    geometry = _ppm_geometry(data[:4096])
    if geometry is not None:
        offset, width, height = geometry
        return np.frombuffer(data, np.uint8, count=width * height * 3,
                             offset=offset).reshape(height, width, 3).copy()
    cv2 = _cv2(path, "its image format")
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if bgr is None:
        raise ValueError(f"{path}: cv2 cannot decode the image")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def read_frame(path) -> np.ndarray:
    """An image file -> RGB uint8 (H, W, 3), decoded by its content."""
    try:
        data = Path(path).read_bytes()
    except FileNotFoundError:
        raise FileNotFoundError(str(path)) from None
    return decode_frame(data, path)


def write_bmp(path, rgb: np.ndarray, top_down: bool = False) -> None:
    """RGB uint8 (H, W, 3) -> a 24-bit uncompressed BMP."""
    h, w, _ = rgb.shape
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = rgb[..., ::-1].reshape(h, w * 3)
    if not top_down:
        rows = rows[::-1]
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54) + struct.pack(
        "<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 24, 0, rows.size, 2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows.tobytes())


# --------------------------------------------------------------------- #
# AVI (RIFF)
# --------------------------------------------------------------------- #


def _chunks(fd: int, start: int, end: int):
    """``(fourcc, body offset, body size, list kind)`` of each chunk in
    bytes ``[start, end)`` of the file; a ``LIST``/``RIFF`` chunk gives its
    kind, its body then starting after the kind."""
    pos = start
    while pos + 8 <= end:
        head = os.pread(fd, 12, pos)
        if len(head) < 8:
            return
        fourcc, size = head[:4], struct.unpack_from("<I", head, 4)[0]
        if fourcc in (b"LIST", b"RIFF"):
            yield fourcc, pos + 12, size - 4, head[8:12]
        else:
            yield fourcc, pos + 8, size, None
        pos += 8 + size + (size & 1)


class AviReader:
    """The first video stream of an AVI file: its geometry, its codec and,
    for uncompressed 24-bit ``BI_RGB``, its frames by index, each one
    ``pread``. Frame chunks are found by walking every ``movi`` list
    (OpenDML ``AVIX`` extensions included), so no index is needed."""

    def __init__(self, path):
        self.path = str(path)
        self.fps = 0.0
        self.width = self.height = self.bits = self.compression = 0
        self.top_down = False
        self._stream: Optional[int] = None
        self._frames: List[Tuple[int, int]] = []
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            head = os.pread(self._fd, 12, 0)
            if head[:4] != b"RIFF" or head[8:12] != b"AVI ":
                raise ValueError(f"{self.path}: not an AVI file")
            for fourcc, off, size, kind in _chunks(self._fd, 0, os.fstat(self._fd).st_size):
                if fourcc == b"RIFF" and kind in (b"AVI ", b"AVIX"):
                    self._walk(off, off + size)
            if self._stream is None:
                raise ValueError(f"{self.path}: no video stream")
        except BaseException:
            self.close()
            raise

    def _walk(self, start: int, end: int) -> None:
        stream = -1
        for _, off, size, kind in _chunks(self._fd, start, end):
            if kind == b"hdrl":
                self._walk(off, off + size)
            elif kind == b"strl":
                stream += 1
                self._read_strl(off, off + size, stream)
            elif kind == b"movi":
                self._walk_movi(off, off + size)

    def _read_strl(self, start: int, end: int, stream: int) -> None:
        parts = {fourcc: (off, size) for fourcc, off, size, _ in _chunks(self._fd, start, end)}
        if self._stream is not None or b"strh" not in parts or b"strf" not in parts:
            return
        strh = os.pread(self._fd, 28, parts[b"strh"][0])
        if strh[:4] != b"vids":
            return
        scale, rate = struct.unpack_from("<II", strh, 20)
        self.fps = rate / scale if scale else 0.0
        strf = os.pread(self._fd, 20, parts[b"strf"][0])
        _, width, height, _, self.bits, self.compression = struct.unpack("<IiiHHI", strf)
        self.width, self.height, self.top_down = width, abs(height), height < 0
        self._stream = stream

    def _walk_movi(self, start: int, end: int) -> None:
        want = (b"%02ddb" % self._stream, b"%02ddc" % self._stream)
        for fourcc, off, size, kind in _chunks(self._fd, start, end):
            if kind == b"rec ":
                self._walk_movi(off, off + size)
            elif fourcc in want:
                self._frames.append((off, size))

    @property
    def codec(self) -> str:
        """The stream's ``biCompression`` as its FourCC (``BI_RGB`` for 0)."""
        if self.compression == 0:
            return "BI_RGB"
        return struct.pack("<I", self.compression).decode("latin-1")

    @property
    def raw(self) -> bool:
        """Uncompressed 24-bit ``BI_RGB``: read here without a decoder."""
        return self.compression == 0 and self.bits == 24

    def __len__(self) -> int:
        return len(self._frames)

    def frame(self, index: int) -> np.ndarray:
        """Frame ``index`` as RGB uint8 (H, W, 3)."""
        if not self.raw:
            raise ValueError(f"{self.path}: codec {self.codec!r} ({self.bits}-bit) is not "
                             "24-bit BI_RGB")
        off, size = self._frames[index]
        stride = (self.width * 3 + 3) & ~3
        if size < stride * self.height:
            raise ValueError(f"{self.path}: frame {index} holds {size} bytes, a frame needs "
                             f"{stride * self.height}")
        bgr = _bgr_rows(os.pread(self._fd, stride * self.height, off), 0, self.width,
                        self.height, stride)
        return np.ascontiguousarray((bgr if self.top_down else bgr[::-1])[..., ::-1])

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_avi_frames(path, frame_ids, reader: Optional[AviReader] = None) -> Dict[int, np.ndarray]:
    """``{frame id: RGB uint8 frame}`` of an AVI: uncompressed ``BI_RGB``
    read here (through ``reader`` when the caller keeps one open), any other
    codec through cv2 (a sequential decode from the first wanted frame, as
    the JAX package reads it) where cv2 can be imported, else
    ``ImportError`` naming the file. Frames past the end are left out."""
    wanted = sorted(set(int(i) for i in frame_ids))
    if reader is None:
        with AviReader(path) as own:
            return read_avi_frames(path, frame_ids, own)
    if reader.raw:
        return {i: reader.frame(i) for i in wanted if i < len(reader)}
    cv2 = _cv2(path, f"its video codec {reader.codec!r}")
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(str(path))
    frames = {}
    try:
        cap.set(cv2.CAP_PROP_POS_FRAMES, wanted[0])
        pos, todo = wanted[0], iter(wanted)
        next_want = next(todo)
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            if pos == next_want:
                frames[pos] = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                next_want = next(todo, None)
                if next_want is None:
                    break
            pos += 1
    finally:
        cap.release()
    return frames


def require_avi_decoder(path) -> None:
    """Raise now the ``ImportError`` that reading ``path`` would raise."""
    with AviReader(path) as reader:
        if not reader.raw:
            _cv2(path, f"its video codec {reader.codec!r}")


def write_avi(path, frames, fps: int = 30, top_down: bool = False) -> None:
    """RGB uint8 frames (each (H, W, 3)) -> an AVI of uncompressed 24-bit
    ``BI_RGB`` frames (``00db`` chunks, rows padded to 4 bytes, bottom-up
    unless ``top_down``) with an ``idx1`` index, written as it goes."""
    frames = iter(frames)
    first = next(frames)
    h, w, _ = first.shape
    stride = (w * 3 + 3) & ~3
    size = stride * h

    def chunk(fourcc: bytes, body: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(body)) + body + (b"\0" if len(body) & 1 else b"")

    def lst(kind: bytes, body: bytes) -> bytes:
        return b"LIST" + struct.pack("<I", len(body) + 4) + kind + body

    def dib(rgb: np.ndarray) -> bytes:
        rows = np.zeros((h, stride), np.uint8)
        rows[:, : w * 3] = rgb[..., ::-1].reshape(h, w * 3)
        return (rows if top_down else rows[::-1]).tobytes()

    def headers(n: int) -> bytes:
        avih = struct.pack("<14I", int(1e6 / fps), size * fps, 0, 0x10, n, 0, 1, size, w, h,
                           0, 0, 0, 0)
        strh = b"vids" + b"DIB " + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n,
                                               size, 0xFFFFFFFF, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, 24, 0, size, 0, 0,
                           0, 0)
        return lst(b"hdrl", chunk(b"avih", avih)
                   + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    frame_chunk = 8 + size + (size & 1)
    with open(path, "wb") as f:
        hdrl_len = len(headers(0))
        f.write(b"\0" * (12 + hdrl_len + 12))  # RIFF, hdrl, movi list header: written last
        n = 0
        for rgb in itertools.chain([first], frames):
            f.write(chunk(b"00db", dib(rgb)))
            n += 1
        movi_size = 4 + n * frame_chunk
        f.write(b"idx1" + struct.pack("<I", 16 * n))
        for i in range(n):
            f.write(b"00db" + struct.pack("<III", 0x10, 4 + i * frame_chunk, size))
        total = f.tell()
        f.seek(0)
        f.write(b"RIFF" + struct.pack("<I", total - 8) + b"AVI " + headers(n)
                + b"LIST" + struct.pack("<I", movi_size) + b"movi")

