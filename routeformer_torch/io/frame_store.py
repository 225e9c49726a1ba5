"""Device-resident frame store: content-hash dedup of the video bytes a
loader copies to the card (counterpart of
``routeformer_tpu/io/frame_store.py``).

GEM samples are overlapping windows (14 s at 2 s steps, reference
``io/dataset.py:967-1033``), so consecutive batches carry ~6/7 of their
frames again, and a second epoch all of them. The store keeps frames on
the card and ships each distinct frame once:

- ``hash_frames`` keys each frame by a blake2b hash of its bytes;
- ``ContentRing`` maps keys to the slots of a fixed-capacity ring,
  evicting in write order and never a slot the current call references
  (it also indexes the device feature memo,
  ``models/video_backbone/cache.py``);
- ``DeviceFrameStore`` holds the ring as one uint8 tensor on the card:
  a call's novel frames go to the card in one pinned, non-blocking copy
  and into their slots by ``index_copy_``, and the call's windows are
  gathered by ``index_select``, the same bits as copying the windows
  whole;
- ``FrameStoreRouter`` keeps one store per (stream, frame shape, dtype)
  under one byte budget.

The JAX store pads each scatter to a power-of-two count of frames so that
XLA compiles a bounded number of programs; PyTorch runs each call at its
own size, so here no call is padded. The store's work is enqueued on the
caller's current CUDA stream: the loader runs it on its producer's side
stream, and the consumer waits for that stream's event. One store belongs
to one producer thread. ``MeshFrameStoreRouter`` is the tier of a
``(data, model)`` mesh: each rank keeps its own stores over its rows.
"""

import hashlib
from typing import Dict, Tuple

import numpy as np
import torch

from routeformer_torch.utils.device import DeviceLike, resolve_device
from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.frame_store")


def hash_frames(flat: np.ndarray) -> list:
    """blake2b-16 content key per leading-axis element (C-contiguous)."""
    keys = []
    for i in range(flat.shape[0]):
        h = hashlib.blake2b(digest_size=16)
        h.update(flat[i])  # buffer protocol, no copy
        keys.append(h.digest())
    return keys


class ContentRing:
    """Host-side index of a device-resident ring buffer."""

    def __init__(self, capacity: int, owner: str = "ContentRing"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.owner = owner
        self._slot_of: Dict[bytes, int] = {}
        self._key_at = [None] * self.capacity
        self._cursor = 0

    def resolve(self, keys):
        """``(idx int32 with -1 where unresolved, novel {key: first
        position}, the resident slots this call needs)``."""
        idx = np.full((len(keys),), -1, np.int32)
        needed: set = set()
        novel: Dict[bytes, int] = {}
        for i, key in enumerate(keys):
            slot = self._slot_of.get(key)
            if slot is not None:
                idx[i] = slot
                needed.add(slot)
            elif key not in novel:
                novel[key] = i
        return idx, novel, needed

    def admit(self, novel_keys, needed: set) -> np.ndarray:
        """Assign slots to the novel keys in order, evicting in write order
        and skipping the slots in ``needed``."""
        slots = np.empty((len(novel_keys),), np.int32)
        for j, key in enumerate(novel_keys):
            for _ in range(self.capacity):
                slot = self._cursor
                self._cursor = (self._cursor + 1) % self.capacity
                if slot not in needed:
                    break
            else:
                raise RuntimeError(
                    f"{self.owner} capacity {self.capacity} cannot hold one call's "
                    "unique frames; raise the byte budget")
            old = self._key_at[slot]
            if old is not None:
                del self._slot_of[old]
            self._slot_of[key] = slot
            self._key_at[slot] = key
            slots[j] = slot
            needed.add(slot)
        return slots

    def fill(self, keys, idx: np.ndarray) -> np.ndarray:
        """Resolve the remaining -1 entries after ``admit``."""
        for i, key in enumerate(keys):
            if idx[i] < 0:
                idx[i] = self._slot_of[key]
        return idx


def host_tensor(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a host tensor to copy to ``device``: pinned
    (page-locked, so the copy can run asynchronously) when ``device`` is a
    card, the array itself otherwise."""
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(array))
    out = torch.empty(array.shape, dtype=torch.from_numpy(array[:0]).dtype, pin_memory=True)
    out.numpy()[...] = array
    return out


class DeviceFrameStore:
    """Ring of frames on the card and its host-side content index."""

    def __init__(self, frame_shape: Tuple[int, ...], dtype, capacity: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        self._ring = ContentRing(capacity, owner="DeviceFrameStore")
        self._store = torch.zeros((self._ring.capacity, *self.frame_shape),
                                  dtype=torch.from_numpy(np.zeros(0, self.dtype)).dtype,
                                  device=self.device)
        self.frames_seen = 0
        self.frames_shipped = 0

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    @property
    def frame_bytes(self) -> int:
        return int(np.prod(self.frame_shape)) * self.dtype.itemsize

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return host_tensor(idx.astype(np.int64), self.device).to(self.device,
                                                                  non_blocking=True)

    def put_windows(self, windows: np.ndarray, keys=None) -> torch.Tensor:
        """(B, T, *frame_shape) host windows -> the same tensor on the card,
        shipping only the frames whose key is not resident. ``keys`` are
        the flattened frames' content hashes when the caller has them."""
        windows = np.ascontiguousarray(windows)
        b, t = windows.shape[:2]
        flat = windows.reshape((-1, *windows.shape[2:]))
        self.frames_seen += flat.shape[0]
        if keys is None:
            keys = hash_frames(flat)
        idx, novel, needed = self._ring.resolve(keys)
        if novel:
            slots = self._ring.admit(list(novel), needed)
            idx = self._ring.fill(keys, idx)
            first = np.fromiter(novel.values(), dtype=np.int64, count=len(novel))
            self.frames_shipped += len(novel)
            frames = host_tensor(flat[first], self.device).to(self.device, non_blocking=True)
            self._store.index_copy_(0, self._index(slots), frames)
        out = self._store.index_select(0, self._index(idx))
        return out.reshape((b, t, *self.frame_shape))


def _store_capacity(windows: np.ndarray, budget_bytes: float, n_streams_hint: int,
                    label: str) -> int:
    """One stream's ring capacity: its share of the byte budget, and never
    below two batches' frames."""
    frame_bytes = int(np.prod(windows.shape[2:]) * windows.dtype.itemsize)
    per_stream = budget_bytes / n_streams_hint
    capacity = int(per_stream // max(frame_bytes, 1))
    min_cap = 2 * windows.shape[0] * windows.shape[1]
    if capacity < min_cap:
        logger.info("frame store %s: budget %.0f MB < 2 batches; raising capacity to %d "
                    "frames", label, per_stream / 1e6, min_cap)
        capacity = min_cap
    return capacity


class FrameStoreRouter:
    """One ``DeviceFrameStore`` per (stream name, frame shape, dtype), the
    byte budget split evenly over ``n_streams_hint`` streams."""

    def __init__(self, budget_bytes: float = 512e6, n_streams_hint: int = 3,
                 device: DeviceLike = None):
        self.budget_bytes = float(budget_bytes)
        self.n_streams_hint = max(1, int(n_streams_hint))
        self.device = resolve_device(device)
        self._stores: Dict[tuple, DeviceFrameStore] = {}

    def put(self, name: str, windows: np.ndarray, keys=None) -> torch.Tensor:
        """``windows`` on the card through its stream's store; ``keys``
        are the flattened frames' content hashes when the caller has
        them."""
        key = (name, windows.shape[2:], np.dtype(windows.dtype).str)
        store = self._stores.get(key)
        if store is None:
            capacity = _store_capacity(windows, self.budget_bytes, self.n_streams_hint, name)
            store = DeviceFrameStore(windows.shape[2:], windows.dtype, capacity,
                                     device=self.device)
            self._stores[key] = store
        return store.put_windows(windows, keys)

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {k[0] + str(k[1]): {"seen": s.frames_seen, "shipped": s.frames_shipped,
                                   "capacity": s.capacity,
                                   "bytes_shipped": s.frames_shipped * s.frame_bytes}
                for k, s in self._stores.items()}


class MeshFrameStoreRouter:
    """The frame store of one rank of a ``(data, model)`` mesh (the JAX
    package's ``MeshFrameStoreRouter``, one process per card): batch row
    ``r`` belongs to data shard ``r // (B / n_data)``, and this rank keeps
    its own ``FrameStoreRouter`` on its card over its shard's rows (a
    model-axis replica ships the same frames as its shard's other ranks).
    ``put`` takes a global batch and returns this rank's rows, the same
    bits as a plain copy of them; ``put_rows`` takes this rank's rows (a
    mesh loader reads no other). ``stats`` sums every rank's stores: a
    collective, called by every rank together. The budget is per card."""

    def __init__(self, mesh, budget_bytes: float = 512e6, n_streams_hint: int = 3,
                 device: DeviceLike = None):
        self.mesh = mesh
        self.local = FrameStoreRouter(budget_bytes, n_streams_hint, device=device)
        self.device = self.local.device

    def put(self, name: str, windows: np.ndarray) -> torch.Tensor:
        """(B, T, *frame) global host windows -> this rank's row block on its
        card; a batch the data shards do not divide raises."""
        from routeformer_torch.parallel.mesh import row_block

        rows = np.ascontiguousarray(windows[row_block(windows.shape[0], self.mesh)])
        return self.local.put(name, rows)

    def put_rows(self, name: str, rows: np.ndarray, keys=None) -> torch.Tensor:
        return self.local.put(name, rows, keys)

    def stats(self) -> Dict[str, Dict[str, int]]:
        from routeformer_torch.parallel.mesh import sum_over_world

        return sum_over_world(self.local.stats(), self.device)
