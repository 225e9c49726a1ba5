"""Pupil Labs recording files (pldata and msgpack objects), with no
``msgpack`` package (counterpart of ``routeformer_tpu/io/file_methods.py``).

A ``<topic>.pldata`` file is a msgpack stream of ``(topic, payload)`` pairs,
each payload itself a msgpack map (nested serialized dicts travel as
ext type 13), beside a ``<topic>_timestamps.npy``; ``world.intrinsics`` is
one msgpack map. The card's machine has no ``msgpack``, so this module
reads and writes the subset of the format these files use in plain
Python: nil, booleans, ints, floats, strings, bin, arrays, maps and ext.
Decoding follows ``msgpack.unpackb(raw=False, strict_map_key=False)``
(strings to ``str``, bin to ``bytes``, float32 widened to a Python
float); encoding follows ``msgpack.packb(use_bin_type=True)`` byte for
byte: the smallest header for every int, string, bin, array, map and ext,
and every Python float as a float64.
"""

import collections
import os
import struct
from pathlib import Path
from typing import Any, Callable, Iterable, Optional, Tuple

import numpy as np

PLData = collections.namedtuple("PLData", ["data", "timestamps", "topics"])
ExtType = collections.namedtuple("ExtType", ["code", "data"])

MSGPACK_EXT_CODE = 13


class _Reader:
    """msgpack decoder over one bytes buffer."""

    def __init__(self, buf: bytes, use_list: bool,
                 ext_hook: Optional[Callable[[int, bytes], Any]]):
        self.buf = memoryview(buf)
        self.pos = 0
        self.use_list = use_list
        self.ext_hook = ext_hook

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (needs {n} more)")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _seq(self, n: int):
        items = [self.read() for _ in range(n)]
        return items if self.use_list else tuple(items)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            if isinstance(key, list):
                raise ValueError("msgpack: unhashable map key")
            out[key] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        return self.ext_hook(code, data) if self.ext_hook else ExtType(code, data)

    def _str(self, n: int) -> str:
        try:
            return bytes(self._take(n)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack: invalid utf-8 string: {e}") from e

    def read(self):
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b <= 0x8F:
            return self._map(b & 0x0F)
        if b <= 0x9F:
            return self._seq(b & 0x0F)
        if b <= 0xBF:
            return self._str(b & 0x1F)
        if b >= 0xE0:
            return b - 0x100
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:
            return bytes(self._take(self._unpack((">B", ">H", ">I")[b - 0xC4])))
        if 0xC7 <= b <= 0xC9:
            return self._ext(self._unpack((">B", ">H", ">I")[b - 0xC7]))
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self._unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self._ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:
            return self._str(self._unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self._seq(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: reserved type byte 0x{b:02x} at {self.pos - 1}")


def unpackb(data: bytes, use_list: bool = True,
            ext_hook: Optional[Callable[[int, bytes], Any]] = None):
    """Decode one msgpack object that fills ``data``."""
    reader = _Reader(data, use_list, ext_hook)
    obj = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} trailing bytes")
    return obj


def unpack_stream(data: bytes, use_list: bool = True,
                  ext_hook: Optional[Callable[[int, bytes], Any]] = None):
    """Every msgpack object of a concatenated stream, in order."""
    reader = _Reader(data, use_list, ext_hook)
    while reader.pos < len(reader.buf):
        yield reader.read()


def _header(n: int, fix: Optional[Tuple[int, int]], codes: Tuple[int, int, int],
            what: str) -> bytes:
    if fix is not None and n <= fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: {what} of {n} items is too long")


def _pack_int(v: int) -> bytes:
    if v >= 0:
        if v < 0x80:
            return bytes([v])
        for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        if v >= -32:
            return bytes([v & 0xFF])
        for code, fmt, limit in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                                 (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: int {v} does not fit 64 bits")


def packb(obj, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """Encode ``obj`` as ``msgpack.packb(obj, use_bin_type=True)`` does."""
    out = bytearray()

    def emit(o, depth=0):
        if depth > 512:
            raise ValueError("msgpack: nesting too deep")
        if o is None:
            out.append(0xC0)
        elif o is True or o is False:
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, int):
            out.extend(_pack_int(o))
        elif isinstance(o, float):
            out.append(0xCB)
            out.extend(struct.pack(">d", o))
        elif isinstance(o, str):
            raw = o.encode("utf-8")
            out.extend(_header(len(raw), (0xA0, 31), (0xD9, 0xDA, 0xDB), "string"))
            out.extend(raw)
        elif isinstance(o, (bytes, bytearray, memoryview)):
            raw = bytes(o)
            out.extend(_header(len(raw), None, (0xC4, 0xC5, 0xC6), "bin"))
            out.extend(raw)
        elif isinstance(o, ExtType):
            n = len(o.data)
            fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
            out.extend(bytes([fixext]) if fixext else
                       _header(n, None, (0xC7, 0xC8, 0xC9), "ext"))
            out.extend(struct.pack(">b", o.code))
            out.extend(o.data)
        elif isinstance(o, (list, tuple)):
            out.extend(_header(len(o), (0x90, 15), (None, 0xDC, 0xDD), "array"))
            for item in o:
                emit(item, depth + 1)
        elif isinstance(o, dict):
            out.extend(_header(len(o), (0x80, 15), (None, 0xDE, 0xDF), "map"))
            for k, v in o.items():
                emit(k, depth + 1)
                emit(v, depth + 1)
        elif default is not None:
            emit(default(o), depth + 1)
        else:
            raise TypeError(f"msgpack: cannot serialize {type(o)}")

    emit(obj)
    return bytes(out)


class Serialized_Dict:
    """Dict-like wrapper that defers decoding until first access."""

    __slots__ = ("_ser_data", "_data")

    def __init__(self, python_dict=None, msgpack_bytes=None):
        if python_dict is not None:
            self._ser_data = packb(python_dict, default=self._pack_ext)
        elif msgpack_bytes is not None:
            self._ser_data = msgpack_bytes
        else:
            raise ValueError("Either python_dict or msgpack_bytes required")
        self._data = None

    @staticmethod
    def _pack_ext(obj):
        if isinstance(obj, Serialized_Dict):
            return ExtType(MSGPACK_EXT_CODE, obj._ser_data)
        raise TypeError(f"cannot serialize {type(obj)}")

    @staticmethod
    def _unpack_ext(code, data):
        if code == MSGPACK_EXT_CODE:
            return Serialized_Dict(msgpack_bytes=data)
        return ExtType(code, data)

    def _deser(self):
        if self._data is None:
            self._data = unpackb(self._ser_data, use_list=False, ext_hook=self._unpack_ext)
        return self._data

    @property
    def serialized(self) -> bytes:
        return self._ser_data

    def __getitem__(self, key):
        return self._deser()[key]

    def __contains__(self, key):
        return key in self._deser()

    def get(self, key, default=None):
        return self._deser().get(key, default)

    def keys(self):
        return self._deser().keys()

    def values(self):
        return self._deser().values()

    def items(self):
        return self._deser().items()

    def __iter__(self):
        return iter(self._deser())

    def __len__(self):
        return len(self._deser())

    def __repr__(self):
        return f"Serialized_Dict({self._deser()!r})"


def load_object(file_path):
    """Decode the one msgpack object of a file (reference
    file_methods.py:46-67)."""
    return unpackb(Path(file_path).expanduser().read_bytes())


def save_object(obj, file_path):
    """Encode one object to a file."""
    Path(file_path).expanduser().write_bytes(packb(obj))


def load_pldata_file(directory, topic: str) -> PLData:
    """Load ``<topic>.pldata`` and ``<topic>_timestamps.npy`` (reference
    file_methods.py:70-96); a corrupt stream raises ``ValueError``."""
    ts_file = os.path.join(directory, topic + "_timestamps.npy")
    pldata_file = os.path.join(directory, topic + ".pldata")
    data = collections.deque()
    topics = collections.deque()
    data_ts = np.load(ts_file)
    with open(pldata_file, "rb") as fh:
        raw = fh.read()
    try:
        for entry in unpack_stream(raw, use_list=False):
            entry_topic, payload = entry
            data.append(Serialized_Dict(msgpack_bytes=payload))
            topics.append(entry_topic)
    except (TypeError, ValueError) as e:
        raise ValueError(f"{pldata_file}: corrupt pldata stream: {e}") from e
    return PLData(data, data_ts, topics)


def save_pldata_file(data: Iterable[dict], timestamps: Iterable[float], directory,
                     topic: str):
    """Write a pldata file pair (the recorder's role; fixtures use it)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / f"{topic}.pldata", "wb") as fh:
        for datum in data:
            fh.write(packb((topic, packb(datum))))
    np.save(directory / f"{topic}_timestamps.npy", np.asarray(list(timestamps)))
