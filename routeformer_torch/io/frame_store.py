"""Content keys and the ring index behind the device feature memo (the
parts of ``routeformer_tpu/io/frame_store.py`` that
``models/video_backbone/cache.py`` uses): ``hash_frames`` keys each frame
by a blake2b hash of its bytes, and ``ContentRing`` maps keys to the slots
of a fixed-capacity ring on the device, evicting in write order and never
a slot that the current call references. The pixel frame store and its
routers serve the data loader and are not ported yet (``ROADMAP.md`` §1
item 4)."""

import hashlib
from typing import Dict

import numpy as np


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
