"""The port's ``GEMDataset`` (``routeformer_torch/io/dataset.py``) against
the JAX package's on the CPU, on the JAX fixture's recording
(``tests/gem_fixture.py``: 20 s at (48, 64), mp4v, which the port decodes
through cv2 here), and on the port's raw recording.

Limits: the sample index lists (starts, PCIs, subjects), every item's
``gps`` and ``gaze`` arrays and ``pci``: exact. Videos: within 1 of the
JAX dataset's (its cv2 undistort and resize), the share of exact elements
printed, in both ``share_decode`` modes; float16 videos are the uint8
ones divided by 255 in float16, exactly."""

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gem_fixture import build_gem_fixture
from routeformer_torch.io.dataset import GEMDataset
from routeformer_torch.io.gem_fixture import build_gem_fixture as build_raw_fixture
from routeformer_tpu.io.dataset import GEMDataset as JaxGEMDataset


@pytest.fixture(scope="module")
def gem_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gem")
    build_gem_fixture(root, duration_s=20.0)
    return root


def _kwargs(root, **extra):
    kw = dict(root=root, split=["001"], input_length=8, target_length=6, step_size=2,
              min_pci=None, output_fps=5, gopro_scaling_factor=0.5,
              front_scaling_factor=0.6, undistort_videos=True)
    kw.update(extra)
    return kw


def _index(ds):
    return [(v["subject"], v["left"].name, v["sample_start_time"], v["pci"])
            for v in ds._indexer.values()]


@pytest.mark.parametrize("extra", [{}, {"min_pci": 1.0}, {"min_pci": 1e9},
                                   {"max_pci": 5.0, "avoid_overlap": True}],
                         ids=["all", "min_pci", "none_left", "avoid_overlap"])
def test_index_lists_match_jax(gem_root, extra):
    """The sample index (subjects, files, starts, PCIs) and the clock
    alignment: exact."""
    kw = _kwargs(gem_root, with_video=False, with_gaze=False, **extra)
    mine, ref = GEMDataset(**kw), JaxGEMDataset(**kw)
    assert _index(mine) == _index(ref)
    meta = next(iter(mine.subject_sample_metadatas["001"].values()))
    ref_meta = next(iter(ref.subject_sample_metadatas["001"].values()))
    for key in ("duration", "origin_time", "left_offset", "right_offset",
                "gaze_sampling_offset", "gaze_video_offset"):
        assert meta[key] == ref_meta[key], key


def _compare_items(mine, ref, shares):
    assert len(mine) == len(ref) == 3
    for i in range(len(ref)):
        a, b = mine[i], ref[i]
        assert a["pci"] == b["pci"]
        for phase in ("train", "target"):
            assert sorted(a[phase]) == sorted(b[phase])
            for key, want in b[phase].items():
                got = a[phase][key]
                assert got.dtype == want.dtype and got.shape == want.shape, key
                if "video" in key:
                    scale = 255 if want.dtype == np.float16 else 1
                    d = np.abs(got.astype(np.float64) - want.astype(np.float64)) * scale
                    assert d.max() <= 1 + 1e-3, (key, d.max())
                    shares.append(float((d == 0).mean()))
                else:
                    np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("share_decode", [True, False], ids=["shared", "per_window"])
def test_items_match_jax(gem_root, share_decode):
    """Every item: gps, gaze and pci exact; videos (undistorted, cropped,
    resized, uint8) within 1 of the JAX dataset's."""
    kw = _kwargs(gem_root, share_decode=share_decode, video_dtype="uint8")
    shares = []
    _compare_items(GEMDataset(**kw), JaxGEMDataset(**kw), shares)
    print("video exact share", min(shares), np.mean(shares))


def test_float16_is_the_uint8_frames_over_255(gem_root):
    """The float16 wire format is the uint8 one divided by 255 in float16,
    exactly, and the gaze mask and TCHW layout follow the JAX dataset."""
    u8 = GEMDataset(**_kwargs(gem_root, video_dtype="uint8"))
    f16 = GEMDataset(**_kwargs(gem_root, video_dtype="float16", output_format="TCHW",
                               mask_nonfixations=True))
    ref = JaxGEMDataset(**_kwargs(gem_root, video_dtype="float16", output_format="TCHW",
                                  mask_nonfixations=True))
    a, b, c = u8[1], f16[1], ref[1]
    for key in ("left_video", "front_video"):
        np.testing.assert_array_equal(
            (a["train"][key].astype(np.float16) / 255.0).transpose(0, 3, 1, 2),
            b["train"][key])
    np.testing.assert_array_equal(b["train"]["gaze"], c["train"]["gaze"])
    assert b["train"]["front_video"].shape == c["train"]["front_video"].shape


def test_caches_round_trip(gem_root, tmp_path):
    """The PCI index cache (the port's own file name) and the sample cache
    (zlib under ``routeformer_torch_dataset/``) give back the same index
    and items; the memory tier serves read-only arrays."""
    kw = _kwargs(gem_root, use_cache=True, cache_dir=tmp_path, use_memory_cache=True)
    first = GEMDataset(**kw)
    items = [first[i] for i in range(len(first))]
    first._sample_cache.flush()
    assert [p.name for p in tmp_path.glob("*.json")] == ["torch_gem_pci_step2_fps5.json"]
    assert len(list((tmp_path / "routeformer_torch_dataset").glob("*.rfz"))) == 3
    again = GEMDataset(**kw)
    assert _index(again) == _index(first)
    for i, item in enumerate(items):
        cached = again[i]
        for phase in ("train", "target"):
            for key, value in item[phase].items():
                np.testing.assert_array_equal(cached[phase][key], value)
    hit = first[0]["train"]["left_video"]
    assert not hit.flags.writeable


def test_raw_recording_and_refusals(tmp_path):
    """The port's raw recording reads through the port's own video
    reader; ``stitch_videos`` adds a double-width float16 stream, warped
    on the device named (no device on a host without a card: the CUDA
    error); ``with_audio``, refused before ``io/audio.py`` was ported, adds
    the three (T, 1) float32 audio streams of the recording's PCM tracks."""
    build_raw_fixture(tmp_path, duration_s=16.0, subject="002", turn=1.0, with_audio=True)
    ds = GEMDataset(root=tmp_path, split="val", min_pci=None, gopro_scaling_factor=0.5,
                    front_scaling_factor=0.5)
    item = ds[0]
    assert item["train"]["left_video"].shape == (40, 24, 12, 3)
    assert item["target"]["front_video"].shape == (30, 24, 32, 3)
    assert item["train"]["gaze"].shape == (1600, 2)
    stitched = GEMDataset(root=tmp_path, split="val", min_pci=None, gopro_scaling_factor=0.5,
                          front_scaling_factor=0.5, stitch_videos=True,
                          stitch_device="cpu")[0]["train"]["stitched_video"]
    assert stitched.shape == (40, 24, 24, 3) and stitched.dtype == np.float16
    assert np.isfinite(stitched).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GEMDataset(root=tmp_path, split="val", stitch_videos=True)
    audio = GEMDataset(root=tmp_path, split="val", min_pci=None, with_video=False,
                       with_audio=True)
    for key in ("left_audio", "right_audio", "front_audio"):
        assert audio[0]["train"][key].shape == (audio.input_audio_frame_count, 1)
        assert audio[0]["train"][key].dtype == np.float32


def test_concurrent_reads_match_sequential(tmp_path):
    """Stress the shared state (windowed readers and their memo, the gaze
    cache, the memory tier): 24 threads read the windows in shuffled order
    with a short switch interval; every item equals a fresh dataset's
    sequential read, bit for bit."""
    build_raw_fixture(tmp_path, duration_s=24.0, subject="001", turn=1.0)
    kw = dict(root=tmp_path, split=["001"], min_pci=None, gopro_scaling_factor=0.5,
              front_scaling_factor=0.5, video_dtype="uint8")
    want = [GEMDataset(**kw)[i] for i in range(5)]
    shared = GEMDataset(use_memory_cache=True, **kw)
    order = [int(i) for i in np.random.default_rng(0).permutation(np.tile(np.arange(5), 6))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(24) as pool:
            got = list(pool.map(shared.__getitem__, order))
    finally:
        sys.setswitchinterval(interval)
    for i, item in zip(order, got):
        for phase in ("train", "target"):
            for key, value in want[i][phase].items():
                np.testing.assert_array_equal(item[phase][key], value, err_msg=f"{i} {key}")
