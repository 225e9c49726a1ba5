"""Content-addressed feature caches for a frozen video backbone
(counterpart of ``routeformer_tpu/models/video_backbone/cache.py``).

A frozen encoder's per-frame features are a pure function of the pixels,
so they can be computed once and served again, keyed by a hash of the frame
bytes. With ``*_video_features`` in a batch the model skips its backbone
(``models/routeformer.py``): steady epochs then run no backbone in the
step at all.

- ``EmbeddingCache``: the host RAM tier, LRU by bytes, in front of a
  disk tier (``cache_dir``) in ``io/cache.SampleCache``'s zlib format
  under ``torch_embcache_<module hash>``: one file per frame, kept across
  runs.
- ``CachedBackbone`` and ``VideoFeaturePrecomputer``: host features
  (``USE_EMBEDDING_CACHE=1|host``), CPU tensors the trainer moves.
- ``DeviceCachedBackbone`` and ``DeviceVideoFeaturePrecomputer``: the
  device memo (``USE_EMBEDDING_CACHE=device``). Features live in one
  preallocated feature store on the memo's device; a call hashes its
  frames on the host, encodes only the novel ones, writes them into their
  ring slots with ``index_copy_`` and gathers the call's features with
  ``index_select``. A warm batch moves no pixel or feature bytes. The JAX
  memo encodes the whole call (its out-of-range padding slots are dropped
  by the scatter) and pads each call to the largest one of its geometry,
  both to keep one compiled program; here neither is needed, so only the
  novel frames go through the backbone and every slot is in range.
- ``MeshDeviceVideoFeaturePrecomputer``: the device memo of one rank of
  a pure data-parallel mesh, over this rank's rows on its card.

Every backbone copy here is a frozen ``deepcopy`` in eval mode: the
trained model's backbone still decays under AdamW, and the caches serve
the features of the weights they were built with, as in the JAX package.
Only valid while the backbone is frozen (the trainer refuses a cache with
an unfreeze epoch).
"""

import copy
import hashlib
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from routeformer_torch.io.frame_store import ContentRing, hash_frames
from routeformer_torch.utils.device import DeviceLike, resolve_device
from routeformer_torch.utils.logging import get_logger

logger = get_logger("video_backbone.cache")

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
_STREAMS = ("left_video", "right_video", "front_video")


def _host_frames(frames) -> np.ndarray:
    if isinstance(frames, torch.Tensor):
        frames = frames.detach().cpu().numpy()
    return np.ascontiguousarray(frames)


def _frozen_copy(backbone, device: torch.device):
    """A frozen eval-mode copy of ``backbone`` on ``device``."""
    return copy.deepcopy(backbone).to(device).eval().requires_grad_(False)


def module_content_hash(module) -> str:
    """blake2b of a module's parameter names and bytes."""
    h = hashlib.blake2b(digest_size=20)
    for name, p in module.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


class EmbeddingCache:
    """Two-tier (RAM, then disk) cache of per-frame embeddings; the RAM
    tier evicts the least recently used first.

    Frame hashing runs outside the lock; the cache mutation and the
    backbone call inside it."""

    def __init__(self, cache_dir: Optional[str] = None, module_hash: str = "",
                 max_memory_bytes: float = 20e9, max_persistent_bytes: float = 200e9,
                 dtype: str = "bfloat16"):
        self.module_hash = module_hash
        self.max_memory_bytes = max_memory_bytes
        self.dtype = _DTYPES[dtype]
        self._memory: OrderedDict = OrderedDict()
        self._memory_bytes = 0
        self._lock = threading.RLock()
        self._disk = None
        if cache_dir is not None:
            from routeformer_torch.io.cache import SampleCache

            self._disk = SampleCache(Path(cache_dir) / f"torch_embcache_{module_hash[:16]}",
                                     params_repr=module_hash,
                                     max_size_bytes=max_persistent_bytes)

    def key(self, frame: np.ndarray) -> str:
        h = hashlib.blake2b(digest_size=20)
        h.update(self.module_hash.encode())
        h.update(np.ascontiguousarray(frame).tobytes())
        return h.hexdigest()

    def _remember(self, key: str, value: torch.Tensor) -> None:
        old = self._memory.pop(key, None)
        if old is not None:
            self._memory_bytes -= old.nbytes
        self._memory[key] = value
        self._memory_bytes += value.nbytes
        while self._memory_bytes > self.max_memory_bytes and self._memory:
            _, evicted = self._memory.popitem(last=False)
            self._memory_bytes -= evicted.nbytes

    def get_or_compute(self, frames: np.ndarray,
                       compute: Callable[[np.ndarray], torch.Tensor]) -> torch.Tensor:
        """Per-call lookup: only the missing frames go through ``compute``.
        Returns a CPU tensor in the cache dtype."""
        n = frames.shape[0]
        keys = [self.key(frames[i]) for i in range(n)]
        with self._lock:
            out: list = [None] * n
            missing = []
            for i, k in enumerate(keys):
                if k in self._memory:
                    self._memory.move_to_end(k)
                    out[i] = self._memory[k]
                    continue
                if self._disk is not None:
                    hit = self._disk.fetch(k)
                    if hit is not None:
                        out[i] = hit
                        self._remember(k, hit)
                        continue
                missing.append(i)
            if missing:
                computed = compute(frames[np.asarray(missing)]).detach().cpu().to(self.dtype)
                for j, i in enumerate(missing):
                    out[i] = computed[j].clone()
                    self._remember(keys[i], out[i])
                    if self._disk is not None:
                        self._disk.push(keys[i], out[i])
        return torch.stack(out)

    @property
    def memory_bytes(self) -> int:
        return self._memory_bytes


class CachedBackbone:
    """A frozen backbone behind the host ``EmbeddingCache``."""

    def __init__(self, backbone, config, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.backbone = _frozen_copy(backbone, self.device)
        self.cache = EmbeddingCache(
            cache_dir=config.cache_dir,
            module_hash=config.cache_module_hash or module_content_hash(backbone),
            max_memory_bytes=config.max_memory_cache_size,
            dtype=config.cache_dtype,
        )

    def _encode(self, frames: np.ndarray) -> torch.Tensor:
        with torch.no_grad():
            return self.backbone(torch.from_numpy(frames).to(self.device))

    def __call__(self, frames) -> torch.Tensor:
        """(N, H, W, C) pixels -> (N, *feature_shape) CPU features."""
        return self.cache.get_or_compute(_host_frames(frames), self._encode)


def _timeline_features(configs, batch: dict, encode) -> dict:
    """Replace each pixel stream of ``batch`` by ``<stream>_features``: the
    features of the frames the model samples (``encode``), scattered onto
    the full timeline with zeros elsewhere."""
    from routeformer_torch.models.routeformer import fps_subsample_indices

    out = dict(batch)
    fps = {"left_video": configs.video_fps, "right_video": configs.video_fps,
           "front_video": configs.gaze_fps}
    for key in _STREAMS:
        if key not in batch:
            continue
        pixels = _host_frames(batch[key])
        b, t = pixels.shape[:2]
        idx = fps_subsample_indices(t, configs.output_fps // fps[key])
        feats = encode(np.ascontiguousarray(pixels[:, idx].reshape((-1,) + pixels.shape[2:])))
        feats = feats.reshape((b, len(idx)) + feats.shape[1:])
        full = feats.new_zeros((b, t) + feats.shape[2:])
        full[:, torch.from_numpy(idx).to(full.device)] = feats
        out[key + "_features"] = full
        del out[key]
    return out


class VideoFeaturePrecomputer:
    """Host batch transform: pixel streams -> cached backbone features
    (CPU tensors, full timeline)."""

    def __init__(self, model, device: DeviceLike = None):
        self.configs = model.configs
        self.backbone = CachedBackbone(model.video_backbone,
                                       model.video_backbone.configs, device=device)

    def __call__(self, batch: dict) -> dict:
        return _timeline_features(self.configs, batch, self.backbone)


class DeviceCachedBackbone:
    """Frozen-backbone features memoised on the device, keyed by pixel
    content: a ring of ``capacity`` feature maps in one preallocated
    tensor, indexed on the host by ``ContentRing``."""

    def __init__(self, backbone, config, capacity_bytes: float = 512e6,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dtype = _DTYPES[config.cache_dtype]
        self.feature_shape = tuple(backbone.output_feature_shape)
        feat_bytes = int(np.prod(self.feature_shape)) * torch.finfo(self.dtype).bits // 8
        capacity = max(int(capacity_bytes // feat_bytes), 256)
        self._ring = ContentRing(capacity, owner="DeviceCachedBackbone")
        self._fstore = torch.zeros((capacity, *self.feature_shape), dtype=self.dtype,
                                   device=self.device)
        self.backbone = _frozen_copy(backbone, self.device)
        self.frames_seen = 0
        self.frames_encoded = 0
        # The ring's resolve/admit and the store's write and read are one
        # step per call.
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._ring.capacity

    def _index(self, slots: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(slots.astype(np.int64)).to(self.device)

    def __call__(self, frames) -> torch.Tensor:
        """(N, H, W, C) host pixels -> (N, *feature_shape) device features."""
        frames = _host_frames(frames)
        keys = hash_frames(frames)
        with self._lock:
            self.frames_seen += len(keys)
            idx, novel, needed = self._ring.resolve(keys)
            if novel:
                slots = self._ring.admit(list(novel), needed)
                idx = self._ring.fill(keys, idx)
                first = np.fromiter(novel.values(), dtype=np.int64, count=len(novel))
                self.frames_encoded += len(novel)
                with torch.no_grad():
                    feats = self.backbone(torch.from_numpy(frames[first]).to(self.device))
                self._fstore.index_copy_(0, self._index(slots), feats.to(self.dtype))
            return self._fstore.index_select(0, self._index(idx))


class DeviceVideoFeaturePrecomputer:
    """``VideoFeaturePrecomputer`` whose features come from one device memo
    shared by all streams: the returned ``*_video_features`` are device
    tensors gathered from it."""

    def __init__(self, model, capacity_bytes: float = 512e6, device: DeviceLike = None):
        self.configs = model.configs
        self.backbone = DeviceCachedBackbone(
            model.video_backbone, model.video_backbone.configs,
            capacity_bytes=capacity_bytes, device=device)

    def __call__(self, batch: dict) -> dict:
        return _timeline_features(self.configs, batch, self.backbone)

    def stats(self) -> dict:
        return {"seen": self.backbone.frames_seen, "encoded": self.backbone.frames_encoded,
                "capacity": self.backbone.capacity}


class MeshDeviceVideoFeaturePrecomputer:
    """The device memo of one rank of a ``(data, model)`` mesh (the JAX
    package's ``MeshDeviceVideoFeaturePrecomputer``, one process per card):
    a ``DeviceVideoFeaturePrecomputer`` on this rank's card over its data
    shard's rows. A numpy video leaf is the global batch (this rank's row
    block is taken; a batch the shards do not divide raises), a tensor is
    this rank's rows already (a mesh loader's); the features are this
    rank's rows on its card, and the other leaves pass unchanged. It
    encodes with a whole backbone, so it needs a pure data-parallel mesh;
    build it before the trainer lays the model out. ``stats`` sums every
    rank's memo (a collective). ``capacity_bytes`` is per card."""

    def __init__(self, model, mesh, capacity_bytes: float = 512e6,
                 device: DeviceLike = None):
        n_data, n_model = mesh.shape
        if n_model != 1:
            raise ValueError(
                "MeshDeviceVideoFeaturePrecomputer needs a pure data-"
                f"parallel mesh (model axis is {n_model}); use the host "
                "embedding cache (USE_EMBEDDING_CACHE=host) under tensor "
                "parallelism")
        if any(hasattr(p, "mesh_spec") for p in model.video_backbone.parameters()):
            raise ValueError("MeshDeviceVideoFeaturePrecomputer: the backbone is laid out "
                             "on the mesh already; build the memo before the trainer")
        self.mesh = mesh
        self.n_data = n_data
        self.configs = model.configs
        self.shard = DeviceVideoFeaturePrecomputer(model, capacity_bytes=capacity_bytes,
                                                   device=device)

    def __call__(self, batch: dict) -> dict:
        from routeformer_torch.parallel.mesh import row_block

        rows = {}
        for key in _STREAMS:
            v = batch.get(key)
            if v is None:
                continue
            if not isinstance(v, torch.Tensor):
                v = np.asarray(v)
                v = v[row_block(v.shape[0], self.mesh)]
            rows[key] = v
        out = {k: v for k, v in batch.items() if k not in rows}
        out.update(_timeline_features(self.configs, rows, self.shard.backbone))
        return out

    def stats(self) -> dict:
        from routeformer_torch.parallel.mesh import sum_over_world

        return sum_over_world(self.shard.stats(), self.shard.backbone.device)
