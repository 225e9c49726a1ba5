"""The port's ``DataLoader`` and frame store (``routeformer_torch/io/
{loader,frame_store}.py``) against the JAX package's on the CPU.

Limits, all exact: the per-epoch batch order and a ``start_batch``
resume against the JAX loader; the ordered pipeline of ``producers > 1``;
``FrameStoreRouter``'s seen/shipped counts and capacities against JAX's on
the same batches; ``DeviceFrameStore``'s output against
``torch.from_numpy`` of the windows, through evictions; a placing loader's
batches against the numpy collate (float64 placed as float32). On the CPU
placement is a plain conversion; the pinned, side-stream path runs on the
card (``chip_smoke.py`` phase 7d)."""

import types

import numpy as np
import pytest
import torch

from routeformer_torch.io.frame_store import DeviceFrameStore, FrameStoreRouter
from routeformer_torch.io.loader import DataLoader, default_collate
from routeformer_torch.train.trainer import ParallelTrainer
from routeformer_tpu.io.frame_store import FrameStoreRouter as JaxFrameStoreRouter
from routeformer_tpu.io.loader import DataLoader as JaxDataLoader

POOL = np.random.default_rng(0).integers(0, 256, (40, 6, 5, 3), dtype=np.uint8)


class WindowSet:
    """Sample ``i``: 8 consecutive frames of ``POOL`` from ``2 i`` (train
    and target halves), a float64 track and its index as ``pci``."""

    def __len__(self):
        return 15

    def __getitem__(self, i):
        frames = POOL[2 * i: 2 * i + 8]
        track = np.arange(10, dtype=np.float64).reshape(5, 2) + i
        return {"train": {"left_video": frames[:4], "gps": track},
                "target": {"left_video": frames[4:], "gps": track[:3]}, "pci": float(i)}


def _order(loader, epoch, start=0):
    loader.set_epoch(epoch, start_batch=start)
    return [np.asarray(b["pci"]).astype(int).tolist() for b in loader]


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False), (True, False)])
def test_batch_order_and_resume_match_jax(shuffle, drop_last):
    """The same batches in the same order, epoch by epoch, and the same
    resumed tail after ``set_epoch(start_batch=)``."""
    kw = dict(batch_size=4, shuffle=shuffle, seed=7, drop_last=drop_last, num_threads=3)
    mine, ref = DataLoader(WindowSet(), **kw), JaxDataLoader(WindowSet(), **kw)
    assert len(mine) == len(ref)
    for epoch in (0, 1, 2):
        assert _order(mine, epoch) == _order(ref, epoch)
    assert _order(mine, 3, start=2) == _order(ref, 3, start=2)
    assert _order(mine, 4) == _order(ref, 4)


def test_pipelined_producers_keep_order():
    """``set_batch_stage`` with 3 producers: each batch transformed once,
    handed out in the single-producer order."""
    seen = []

    def stage(batch):
        seen.append(int(batch["pci"][0]))
        return dict(batch, staged=True)

    loader = DataLoader(WindowSet(), batch_size=2, shuffle=True, seed=3)
    want = _order(loader, 1)
    loader.set_batch_stage(stage, producers=3)
    loader.set_epoch(1)
    got = list(loader)
    assert [np.asarray(b["pci"]).astype(int).tolist() for b in got] == want
    assert all(b["staged"] for b in got) and sorted(seen) == sorted(w[0] for w in want)


def test_router_counts_match_jax():
    """The same batches through both routers: the same outputs, and the
    same seen/shipped counts and ring capacities per stream, through
    evictions (a budget of about two batches)."""
    data = WindowSet()
    mine = FrameStoreRouter(budget_bytes=3 * 64 * 90, n_streams_hint=1, device="cpu")
    ref = JaxFrameStoreRouter(budget_bytes=3 * 64 * 90, n_streams_hint=1)
    rng = np.random.default_rng(1)
    for _ in range(6):
        batch = default_collate([data[int(i)] for i in rng.choice(15, 4, replace=False)])
        for phase in ("train", "target"):
            w = batch[phase]["left_video"]
            got = mine.put("left_video", w)
            assert torch.equal(got, torch.from_numpy(w))
            np.testing.assert_array_equal(np.asarray(ref.put("left_video", w)), w)
    got, want = mine.stats(), ref.stats()
    assert {k: {f: v[f] for f in ("seen", "shipped", "capacity")} for k, v in got.items()} == want
    stream = next(iter(got.values()))
    assert 0 < stream["shipped"] < stream["seen"]
    assert stream["bytes_shipped"] == stream["shipped"] * 90


def test_device_frame_store_is_exact_through_evictions():
    """``put_windows`` returns ``torch.from_numpy`` of its windows, bit for
    bit, while a small ring evicts; resident frames are not shipped again."""
    store = DeviceFrameStore((6, 5, 3), np.uint8, capacity=16, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(12):
        starts = rng.integers(0, 32, 2)
        windows = np.stack([POOL[s: s + 8] for s in starts])
        assert torch.equal(store.put_windows(windows), torch.from_numpy(windows))
    assert store.frames_seen == 12 * 16 and store.frames_shipped < store.frames_seen
    before = store.frames_shipped
    store.put_windows(windows)
    assert store.frames_shipped == before


@pytest.mark.parametrize("dedup", [False, True], ids=["plain", "frame_store"])
def test_placing_loader_matches_the_numpy_collate(dedup):
    """``to_device=True`` on the CPU device: every batch equals
    ``torch.from_numpy`` of the numpy collate of its samples, float64
    leaves as float32, video bytes through the frame store when asked."""
    data = WindowSet()
    loader = DataLoader(data, batch_size=4, shuffle=True, seed=5, to_device=True,
                        h2d_dedup=dedup, device="cpu")
    served = set()
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        order = loader.batch_indices()
        for placed, idx in zip(loader, order):
            served.update(f for i in idx for f in range(2 * int(i), 2 * int(i) + 8))
            want = default_collate([data[int(i)] for i in idx])
            for phase in ("train", "target"):
                for key, value in want[phase].items():
                    expect = value.astype(np.float32) if value.dtype == np.float64 else value
                    assert torch.equal(placed[phase][key], torch.from_numpy(expect)), key
            assert placed["pci"].dtype == torch.float32
    stats = loader.frame_store_stats()
    assert bool(stats) == dedup
    if dedup:
        s = stats["left_video(6, 5, 3)"]
        assert s["seen"] == 2 * 3 * 4 * 8 and s["shipped"] == len(served)
    assert loader.bytes_copied > 0


def test_refusals_and_the_trainers_placement():
    """``mesh=`` takes a ``make_mesh`` DeviceMesh only, and producers > 1
    with the frame store raise; the trainer uses tensors already on its
    device as they are (no copy) and copies numpy leaves, float64 as
    float32."""
    with pytest.raises(TypeError, match="DeviceMesh of make_mesh"):
        DataLoader(WindowSet(), mesh=object())
    with pytest.raises(ValueError, match="producers > 1"):
        DataLoader(WindowSet(), to_device=True, h2d_dedup=True, producers=2, device="cpu")
    trainer = types.SimpleNamespace(device=torch.device("cpu"), mesh=None)
    video = torch.zeros((1, 2, 3, 3, 3), dtype=torch.float16)
    gps = np.ones((1, 4, 2))
    placed = ParallelTrainer._place(trainer, {"left_video": video, "gps": gps})
    assert placed["left_video"] is video
    assert placed["gps"].dtype == torch.float32 and torch.equal(placed["gps"],
                                                                torch.ones(1, 4, 2))
