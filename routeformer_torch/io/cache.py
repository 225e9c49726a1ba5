"""Content-addressed, size-bounded sample cache (counterpart of
``routeformer_tpu/io/cache.py``), compressed with the standard library's
``zlib`` instead of ``zstandard``, which the card's machine lacks.

Each item is one file, ``<blake2b key>.rfz``: the magic ``PORT_MAGIC``
(format and version), then a zlib stream of the item's pickle. The key
hashes ``CACHE_VERSION``, the item's identity and the parameters that
shape its content. The format is the port's own and not byte-compatible
with the JAX cache (``.zst`` files under ``routeformer_dataset/``); the
port writes under its own subdirectory names, reads only ``.rfz`` files,
and treats a file without its magic as corrupt. As in the JAX cache: a
bounded total size, corrupt entries deleted and recomputed, optional
asynchronous writes, ``get_or_compute``. Only files this cache wrote are
unpickled.
"""

import hashlib
import os
import pickle
import queue
import threading
import zlib
from pathlib import Path
from typing import Any, Callable, Optional

from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.cache")

CACHE_VERSION = "torch-1"
PORT_MAGIC = b"RFTORCH-ZLIB-1\n"
SUFFIX = ".rfz"


class SampleCache:
    """Disk cache of dataset samples.

    Thread-safe: zlib's one-shot calls keep no shared state. With
    ``async_writes=True`` the compression and the file write move to one
    background writer; the sample is pickled at ``push`` time, so the
    caller may change it afterwards. ``flush()`` waits for queued writes."""

    def __init__(self, cache_dir, params_repr: str = "", max_size_bytes: float = 200e9,
                 version: str = CACHE_VERSION, compression_level: int = 1,
                 async_writes: bool = False):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.params_repr = params_repr
        self.max_size_bytes = max_size_bytes
        self.version = version
        self._level = compression_level
        self._size_lock = threading.Lock()
        self._size: Optional[int] = None
        self._queue: Optional[queue.Queue] = None
        if async_writes:
            self._queue = queue.Queue(maxsize=8)
            self._writer = threading.Thread(target=self._writer_loop, daemon=True,
                                            name="SampleCache-writer")
            self._writer.start()

    def key(self, item_repr: str) -> str:
        h = hashlib.blake2b(digest_size=20)
        h.update(self.version.encode())
        h.update(item_repr.encode())
        h.update(self.params_repr.encode())
        return h.hexdigest()

    def _path(self, key: str) -> Path:
        return self.cache_dir / f"{key}{SUFFIX}"

    def _encode(self, raw: bytes) -> bytes:
        return PORT_MAGIC + zlib.compress(raw, self._level)

    def fetch(self, item_repr: str) -> Optional[Any]:
        """A cached sample, or None; a corrupt entry is removed (a miss)."""
        path = self._path(self.key(item_repr))
        if not path.exists():
            return None
        try:
            data = path.read_bytes()
            if not data.startswith(PORT_MAGIC):
                raise ValueError("not a file of this cache's format")
            return pickle.loads(zlib.decompress(data[len(PORT_MAGIC):]))
        except (OSError, ValueError, zlib.error, pickle.UnpicklingError, EOFError) as e:
            logger.warning("corrupt cache entry %s (%s); removing", path.name, e)
            try:
                freed = path.stat().st_size
            except OSError:
                freed = 0
            path.unlink(missing_ok=True)
            with self._size_lock:
                if self._size is not None:
                    self._size = max(0, self._size - freed)
            return None

    def push(self, item_repr: str, sample: Any) -> bool:
        """Write a sample unless the cache holds its size bound already."""
        if self.size_bytes() >= self.max_size_bytes:
            logger.info("cache full (%d bytes); skipping write", self.size_bytes())
            return False
        path = self._path(self.key(item_repr))
        raw = pickle.dumps(sample, protocol=pickle.HIGHEST_PROTOCOL)
        if self._queue is not None:
            self._queue.put((path, raw))
            return True
        self._write(path, self._encode(raw))
        return True

    def _write(self, path: Path, payload: bytes) -> None:
        tmp = path.with_name(path.name + f".{threading.get_ident()}.tmp")
        with open(tmp, "wb") as fh:
            fh.write(payload)
        os.replace(tmp, path)
        with self._size_lock:
            if self._size is not None:
                self._size += len(payload)

    def _writer_loop(self) -> None:
        while True:
            path, raw = self._queue.get()
            try:
                self._write(path, self._encode(raw))
            except OSError as e:  # cache writes are best-effort
                logger.warning("async cache write failed for %s: %s", path.name, e)
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        """Block until every queued write is on disk."""
        if self._queue is not None:
            self._queue.join()

    def get_or_compute(self, item_repr: str, compute: Callable[[], Any]) -> Any:
        sample = self.fetch(item_repr)
        if sample is not None:
            return sample
        sample = compute()
        self.push(item_repr, sample)
        return sample

    def size_bytes(self) -> int:
        with self._size_lock:
            if self._size is None:
                self._size = sum(p.stat().st_size for p in self.cache_dir.glob(f"*{SUFFIX}"))
            return self._size

    def clear(self) -> None:
        self.flush()
        for p in self.cache_dir.glob(f"*{SUFFIX}"):
            p.unlink()
        with self._size_lock:
            self._size = 0
