"""Streaming batch loader with background prefetch (counterpart of
``routeformer_tpu/io/loader.py``).

Samples are assembled by a pool of threads, collated by a producer thread
and kept in a bounded queue, so host work overlaps the consumer's step. Batch order is the JAX loader's: the same
per-epoch shuffle from ``np.random.default_rng(seed + epoch)``, the same
per-process stride, ``set_epoch(start_batch=)`` to resume, and
``set_batch_stage`` to run a host stage (``producers > 1`` pipelines it
over batches, in order), and ``set_placed_stage`` to run one on the placed
batch (on the producer thread, before the batch is handed out: e.g.
views of the placed tensors, with no copy).

Placement (``to_device=True``) is the port's own: each leaf is collated
into a pinned host tensor and copied with ``non_blocking=True`` on a CUDA
stream that the producer owns; the producer records an event after the
batch's copies, and the consumer's stream waits on it before the batch is
handed out, so no batch is read before its copy lands (the tensors are
also recorded on the consumer's stream, so the allocator keeps them until
the consumer is done). ``h2d_dedup=True`` sends every 5-D ``*video*``
leaf through a ``FrameStoreRouter`` (``io/frame_store.py``), its byte
budget split over the video streams of the first batch placed: their
frames are hashed on the sample pool (hashlib releases the interpreter
lock) and only the frames not yet on the card are staged in pinned
memory and copied. Float64 leaves (GPS, gaze, PCI) are
placed as float32, as JAX places them. On the CPU device placement is a
plain conversion.

``mesh=`` (a ``DeviceMesh`` of ``parallel.make_mesh``, one loader per
rank): the epoch's global batches are the JAX loader's, and each rank
reads, collates and places only its own row block (batch row ``r`` goes to
data shard ``r // (B / n_data)``); its leaves are tensors, on its card with
``to_device``, else on the CPU (a tensor is a rank's rows to the trainer
and the mesh memo, a numpy leaf a global batch). With the frame store the
order is the JAX loader's shard-stable one: each sample belongs to one data
shard for good (its position in the process's pool modulo ``n_data``), the
pools are shuffled apart by ``default_rng(seed + epoch)``, and each batch is
``n_data`` contiguous row blocks, one per shard, so a rank's frame store
(``MeshFrameStoreRouter``) sees only its shard's frames.
"""

import queue
import threading
from collections import deque
from multiprocessing.pool import ThreadPool
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from routeformer_torch.io.frame_store import (
    FrameStoreRouter,
    MeshFrameStoreRouter,
    hash_frames,
    host_tensor,
)
from routeformer_torch.utils.device import DeviceLike, resolve_device
from routeformer_torch.utils.logging import get_logger

logger = get_logger("io.loader")


def canonical(array: np.ndarray) -> np.ndarray:
    """float64 -> float32 (JAX's placement without x64); others as they are."""
    return array.astype(np.float32) if array.dtype == np.float64 else array


def default_collate(samples: Sequence[dict], empty: Optional[Callable] = None) -> dict:
    """Stack a list of sample dicts into one batch dict (nested). ``empty``
    allocates each leaf's output (``empty(shape, dtype)`` -> a tensor whose
    ``.numpy()`` is written), e.g. in pinned memory; by default leaves are
    numpy arrays."""
    out = {}
    for key, value in samples[0].items():
        values = [s[key] for s in samples]
        if isinstance(value, dict):
            out[key] = default_collate(values, empty)
        elif not isinstance(value, np.ndarray):
            values = np.asarray(values)
            out[key] = values if empty is None else empty(values.shape, values.dtype)
            if empty is not None:
                out[key].numpy()[...] = values
        elif empty is None:
            out[key] = np.stack(values)
        else:
            out[key] = empty((len(values),) + value.shape, value.dtype)
            np.stack(values, out=out[key].numpy())
    return out


class DataLoader:
    """Prefetching batch iterator over an indexable dataset."""

    def __init__(self, dataset, batch_size: int = 16, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = True, num_threads: int = 8, prefetch: int = 2,
                 collate_fn: Optional[Callable] = None,
                 batch_transform: Optional[Callable] = None, producers: int = 1,
                 process_index: int = 0, process_count: int = 1, to_device: bool = False,
                 h2d_dedup: bool = False, dedup_budget_bytes: float = 512e6, mesh=None,
                 device: DeviceLike = None):
        self.mesh = mesh
        self._rows = None  # this rank's row block of each batch, on a mesh
        if mesh is not None:
            from routeformer_torch.parallel.mesh import check_mesh, row_block

            check_mesh(mesh)
            self._rows = row_block(batch_size, mesh)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.collate_fn = collate_fn
        self.batch_transform = None
        self.placed_transform: Optional[Callable] = None
        self.producers = 1
        self.set_batch_stage(batch_transform, producers, _h2d_dedup=h2d_dedup and to_device)
        self.process_index = process_index
        self.process_count = process_count
        self.to_device = to_device
        self.h2d_dedup = h2d_dedup and to_device
        self.device = resolve_device(device) if to_device else None
        self.dedup_budget_bytes = dedup_budget_bytes
        self._router = None  # a (Mesh)FrameStoreRouter, built at the first batch placed
        self._bytes_lock = threading.Lock()
        self.bytes_copied = 0  # host -> device bytes of the leaves placed whole
        self._epoch = 0
        self._start_batch = 0

    def set_batch_stage(self, transform: Optional[Callable], producers: int = 1,
                        _h2d_dedup: Optional[bool] = None) -> None:
        """(Re)attach the producer-side host stage run on each collated
        batch before placement; ``producers > 1`` runs it on that many
        threads over consecutive batches, in order (the transform must then
        be thread-safe). The frame store is one sequential ring, so dedup
        takes one producer."""
        dedup = self.h2d_dedup if _h2d_dedup is None else _h2d_dedup
        producers = max(int(producers), 1)
        if producers > 1 and dedup:
            raise ValueError(
                "producers > 1 is not supported with h2d_dedup (the frame-store ring is "
                "a sequential structure); run the dedup tier with one producer or drop "
                "h2d_dedup")
        self.batch_transform = transform
        self.producers = producers

    def set_placed_stage(self, transform: Optional[Callable]) -> None:
        """(Re)attach a stage run on each placed batch (after the host stage
        and the copies), on the producer thread; ``to_device`` only."""
        if transform is not None and not self.to_device:
            raise ValueError("a placed stage needs to_device=True; use set_batch_stage")
        self.placed_transform = transform

    def frame_store_stats(self) -> dict:
        """``{stream: {seen, shipped, capacity, bytes_shipped}}`` of the
        frame store (empty without ``h2d_dedup``)."""
        return {} if self._router is None else self._router.stats()

    def _empty(self, shape, dtype) -> torch.Tensor:
        dtype = canonical(np.zeros(0, dtype)).dtype
        return torch.empty(shape, dtype=torch.from_numpy(np.zeros(0, dtype)).dtype,
                           pin_memory=self.device.type == "cuda")

    def _collate(self, samples) -> dict:
        """Collate; straight into pinned memory when this loader places
        whole leaves and no host stage comes first (with the frame store
        the video leaves stay numpy: only their novel frames are staged)."""
        if self.collate_fn is not None:
            return self.collate_fn(samples)
        if self.to_device and self.batch_transform is None and not self.h2d_dedup:
            return default_collate(samples, empty=self._empty)
        return default_collate(samples)

    def _place(self, batch: dict, pool: Optional[ThreadPool] = None) -> dict:
        if self.h2d_dedup and self._router is None:
            kw = dict(budget_bytes=self.dedup_budget_bytes,
                      n_streams_hint=_video_streams(batch), device=self.device)
            self._router = (FrameStoreRouter(**kw) if self.mesh is None
                            else MeshFrameStoreRouter(self.mesh, **kw))
        return self._place_leaves(batch, pool)

    def _place_leaves(self, batch: dict, pool: Optional[ThreadPool]) -> dict:
        out = {}
        for k, v in batch.items():
            if isinstance(v, dict):
                out[k] = self._place_leaves(v, pool)
                continue
            if self._router is not None and "video" in k and getattr(v, "ndim", 0) == 5:
                # one store per stream name: a frame in one sample's train
                # window and a neighbour's target window is shipped once
                host = np.ascontiguousarray(v.numpy() if isinstance(v, torch.Tensor) else v)
                flat = host.reshape((-1,) + host.shape[2:])
                if pool is None:
                    keys = hash_frames(flat)
                else:  # hashlib releases the interpreter lock: hash on the pool
                    bounds = np.linspace(0, len(flat), self.num_threads + 1).astype(int)
                    parts = pool.map(lambda ab: hash_frames(flat[ab[0]:ab[1]]),
                                     zip(bounds[:-1], bounds[1:]))
                    keys = [key for part in parts for key in part]
                put = self._router.put if self.mesh is None else self._router.put_rows
                out[k] = put(k, host, keys=keys)
                continue
            if not isinstance(v, torch.Tensor):
                v = host_tensor(canonical(np.asarray(v)), self.device)
            with self._bytes_lock:
                self.bytes_copied += v.numel() * v.element_size()
            out[k] = v.to(self.device, non_blocking=True)
        return out

    def _placed(self, batch: dict) -> dict:
        return batch if self.placed_transform is None else self.placed_transform(batch)

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Reshuffle for ``epoch`` (DistributedSampler's role);
        ``start_batch`` skips that many batches of the epoch's order,
        unassembled (a resume)."""
        self._epoch = epoch
        self._start_batch = start_batch
        if self._router is not None and epoch > 0:
            for name, s in self._router.stats().items():
                ratio = s["shipped"] / max(s["seen"], 1)
                msg = "frame store %s: %d/%d frames shipped (%.1f%%), capacity %d"
                if ratio > 0.5:
                    logger.warning(msg + " — raise dedup_budget_bytes", name, s["shipped"],
                                   s["seen"], 100 * ratio, s["capacity"])
                else:
                    logger.info(msg, name, s["shipped"], s["seen"], 100 * ratio,
                                s["capacity"])

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.mesh is not None and self.h2d_dedup:
            return self._shard_stable_indices(idx)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx[self.process_index:: self.process_count]

    def _shard_stable_indices(self, idx: np.ndarray) -> np.ndarray:
        """The JAX loader's mesh order: per-shard pools ``host[d::n_data]``
        of the process's samples, each shuffled by one
        ``default_rng(seed + epoch)`` in turn, and batches of ``n_data``
        contiguous per-shard row blocks."""
        host = idx[self.process_index:: self.process_count]
        n_data = self.mesh.size(0)
        rows = self.batch_size // n_data
        parts = [host[d::n_data].copy() for d in range(n_data)]
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            for p in parts:
                rng.shuffle(p)
        n_batches = min(len(p) for p in parts) // rows
        out = np.empty((n_batches, n_data, rows), idx.dtype)
        for d, p in enumerate(parts):
            out[:, d] = p[: n_batches * rows].reshape(n_batches, rows)
        return out.reshape(-1)

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def batch_indices(self) -> list:
        """The dataset indices of each batch of the current epoch, in order
        (before ``start_batch`` is applied)."""
        indices = self._indices()
        return [indices[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(len(self))]

    def __iter__(self) -> Iterator[dict]:
        batches = self.batch_indices()
        if self._start_batch:
            batches = batches[self._start_batch:]
            self._start_batch = 0  # one-shot: later epochs start at 0
        cuda = self.to_device and self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        # maxsize 0 would make the queue unbounded: prefetch 0 still keeps
        # one batch in flight
        out_q: queue.Queue = queue.Queue(maxsize=max(self.prefetch, 1))
        stop = threading.Event()

        def produce():
            try:
                with ThreadPool(self.num_threads) as pool:

                    def make(batch_idx):
                        if self._rows is not None:  # this rank reads its rows only
                            batch_idx = batch_idx[self._rows]
                        samples = pool.map(self.dataset.__getitem__,
                                           [int(i) for i in batch_idx])
                        batch = self._collate(samples)
                        if self.mesh is not None and not self.to_device:
                            batch = _as_tensors(batch)
                        if self.batch_transform is not None:
                            batch = self.batch_transform(batch)
                        if not self.to_device:
                            return batch, None
                        if side is None:
                            return self._placed(self._place(batch, pool)), None
                        with torch.cuda.stream(side):
                            batch = self._placed(self._place(batch, pool))
                            done = torch.cuda.Event()
                            done.record(side)
                        return batch, done

                    if self.producers == 1:
                        for batch_idx in batches:
                            if stop.is_set():
                                return
                            out_q.put(make(batch_idx))
                    else:
                        # bounded, ordered pipeline: at most producers +
                        # prefetch batches in flight
                        with ThreadPool(self.producers) as stage:
                            pending: deque = deque()
                            todo = iter(batches)
                            exhausted = False
                            while True:
                                while not exhausted and len(pending) < (self.producers
                                                                        + self.prefetch):
                                    nxt = next(todo, None)
                                    if nxt is None:
                                        exhausted = True
                                    else:
                                        pending.append(stage.apply_async(make, (nxt,)))
                                if not pending:
                                    break
                                item = pending.popleft().get()
                                if stop.is_set():
                                    return
                                out_q.put(item)
            except Exception as e:  # noqa: BLE001 — surfaced on the consumer's side
                out_q.put(e)
            finally:
                out_q.put(None)

        worker = threading.Thread(target=produce, daemon=True, name="DataLoader-producer")
        worker.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                batch, done = item
                if done is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(done)
                    _record_stream(batch, consumer)
                yield batch
        finally:
            stop.set()
            while worker.is_alive():
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    continue
            worker.join()


def _video_streams(batch: dict) -> int:
    """The 5-D ``*video*`` leaves of a batch, by name (the frame store's
    streams; at least 1)."""
    names = set()

    def walk(d):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v)
            elif "video" in k and getattr(v, "ndim", 0) == 5:
                names.add(k)

    walk(batch)
    return max(len(names), 1)


def _as_tensors(batch: dict) -> dict:
    """A rank's host rows as CPU tensors (float64 as float32)."""
    return {k: _as_tensors(v) if isinstance(v, dict) else
            v if isinstance(v, torch.Tensor) else torch.from_numpy(canonical(np.asarray(v)))
            for k, v in batch.items()}


def _record_stream(batch: dict, stream) -> None:
    for v in batch.values():
        if isinstance(v, dict):
            _record_stream(v, stream)
        elif isinstance(v, torch.Tensor) and v.is_cuda:
            v.record_stream(stream)
