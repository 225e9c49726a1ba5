"""The port's readers against the JAX package's on the CPU
(``routeformer_torch/io/{mp4,gpmf,resample,file_methods,gaze,video,cache}.py``
and the host image ops of ``ops/image.py``), on the JAX fixture's
recording (``tests/gem_fixture.py``: mp4v video, which the port decodes
through cv2 here) and on the port's own raw recording
(``routeformer_torch/io/gem_fixture.py``).

Limits: exact for the MP4 tables, GPMF points, pldata, intrinsics,
resampling, fixation masks, the raw reader (cv2 reads these raw files
here, so the JAX ``read_video`` is its reference, and the frames written
are the second one) and the cache round trip; the undistort and resize
within 1 of the JAX package's cv2 calls, the share of exact elements
printed (1.0 with cv2 5.0)."""

import dataclasses
import struct
import sys

import msgpack
import numpy as np
import pytest

import gem_fixture as jax_fixture
from routeformer_torch.io import cache as port_cache
from routeformer_torch.io import file_methods as port_fm
from routeformer_torch.io import gaze as port_gaze
from routeformer_torch.io import gem_fixture as port_fixture
from routeformer_torch.io import gpmf as port_gpmf
from routeformer_torch.io import mp4 as port_mp4
from routeformer_torch.io import resample as port_resample
from routeformer_torch.io import video as port_video
from routeformer_torch.ops import image as port_image
from routeformer_tpu.io import cache as jax_cache
from routeformer_tpu.io import file_methods as jax_fm
from routeformer_tpu.io import gaze as jax_gaze
from routeformer_tpu.io import gpmf as jax_gpmf
from routeformer_tpu.io import mp4 as jax_mp4
from routeformer_tpu.io import resample as jax_resample
from routeformer_tpu.io import video as jax_video
from routeformer_tpu.io.dataset import GEMDataset as JaxGEM
from routeformer_tpu.ops import image as jax_image


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """The JAX fixture's subject 001 (mp4v) and the port's (raw), 20 s at
    (48, 64)."""
    jax_root = tmp_path_factory.mktemp("jax_gem")
    jax_fixture.build_gem_fixture(jax_root, duration_s=20.0)
    raw_root = tmp_path_factory.mktemp("raw_gem")
    port_fixture.build_gem_fixture(raw_root, duration_s=20.0)
    return jax_root, raw_root


def _files(root):
    return {"left": root / "01GoPro" / "001" / "left" / "GH010008.MP4",
            "world": root / "02EyeTracker" / "001" / "world.mp4"}


def exact_share(a, b, limit=1):
    """|a - b| <= limit everywhere; returns the share of exact elements."""
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    assert d.max(initial=0) <= limit, d.max()
    return float((d == 0).mean()) if d.size else 1.0


# ------------------------------------------------------------------ mp4 #

@pytest.mark.parametrize("which", ["jax-left", "jax-world", "raw-left", "raw-world"])
def test_mp4_tracks_and_sample_tables(recordings, which):
    """Every track field, the sample offsets and times, and each track's
    bytes: exact against the JAX demuxer."""
    kind, name = which.split("-")
    path = _files(recordings[0 if kind == "jax" else 1])[name]
    mine, ref = port_mp4.MP4(path), jax_mp4.MP4(path)
    assert (mine.timescale, mine.duration, mine.creation_time) == \
        (ref.timescale, ref.duration, ref.creation_time)
    assert len(mine.tracks) == len(ref.tracks) >= 1
    for a, b in zip(mine.tracks, ref.tracks):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.sample_offsets() == b.sample_offsets()
        assert mine.read_track(a, 0.2, 0.9) == ref.read_track(b, 0.2, 0.9)
    assert (mine.gpmd_track() is None) == (ref.gpmd_track() is None) == (name == "world")
    if kind == "raw":
        h, w = 48, 64
        assert mine.video_track().codec == "raw "
        assert mine.video_track().visual == (w, h, 24)


# ----------------------------------------------------------------- gpmf #

def test_gpmf_points_and_round_trip(recordings):
    """The fixture's GPS points (every field, the dilutions) from both
    parsers; ``encode_gpmf`` writes the JAX encoder's bytes and parses back
    to the same items."""
    path = _files(recordings[0])["left"]
    raw = jax_mp4.read_gpmf_data(path)
    mine, mine_dil = port_gpmf.build_gps_points(raw)
    ref, ref_dil = jax_gpmf.build_gps_points(raw, prefer_native=False)
    assert len(mine) == len(ref) > 300
    assert [dataclasses.astuple(p) for p in mine] == [dataclasses.astuple(p) for p in ref]
    assert mine_dil == ref_dil
    items = [("SCAL", "l", struct.pack(">lllll", 10, 10, 1, 1, 1), 4, 5),
             ("GPSU", "U", b"230515120000.000", 16, 1),
             ("GPS5", "l", struct.pack(">lllll", 4, 8, 1, 2, 3) * 3, 20, 3),
             ("NAME", "c", b"left cam", 8, 1)]
    data = port_gpmf.encode_gpmf(items)
    assert data == jax_gpmf.encode_gpmf(items)
    assert [dataclasses.astuple(k) for k in port_gpmf.parse_gpmf(data)] == \
        [dataclasses.astuple(k) for k in jax_gpmf.parse_gpmf(data)]
    assert port_fixture.gpmf_stream(jax_fixture.make_trajectory(5.0), jax_fixture.T0) == \
        jax_fixture.gpmf_stream(jax_fixture.make_trajectory(5.0), jax_fixture.T0)


# ------------------------------------------------------------- resample #

def test_resampling_matches_jax():
    """Web-mercator both ways and PChip onto the output grid (with the
    ffill/bfill edges): exact."""
    rng = np.random.default_rng(5)
    latlon = np.stack([rng.uniform(40, 60, 50), rng.uniform(-5, 20, 50)], -1)
    xy = port_resample.convert_gps_coordinates(latlon)
    np.testing.assert_array_equal(xy, jax_resample.convert_gps_coordinates(latlon))
    np.testing.assert_array_equal(port_resample.inverse_gps_coordinates(xy),
                                  jax_resample.inverse_gps_coordinates(xy))
    t = np.sort(rng.uniform(0.5, 9.5, 40))
    got = port_resample.pchip_resample(t, xy[:40], 0.0, 10.0, 5)
    want = jax_resample.pchip_resample(t, xy[:40], 0.0, 10.0, 5)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- pldata #

PACK_CASES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63,
    0.5, -1e300, float("inf"), "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
    b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 70000, [], [1] * 15, [2] * 16, [3] * 70000,
    {}, {i: i for i in range(15)}, {str(i): [i, float(i)] for i in range(16)},
    {"norm_pos": (0.5, 0.25), "confidence": 0.99, "topic": "gaze.pi", "nested": {"a": [b"x"]}},
]


@pytest.mark.parametrize("case", range(len(PACK_CASES)))
def test_msgpack_subset_matches_msgpack(case):
    """The port's encoder writes ``msgpack.packb(use_bin_type=True)``'s
    bytes; its decoder reads them back to ``msgpack.unpackb``'s values."""
    obj = PACK_CASES[case]
    data = port_fm.packb(obj)
    assert data == msgpack.packb(obj, use_bin_type=True)
    for use_list in (True, False):
        assert port_fm.unpackb(data, use_list=use_list) == msgpack.unpackb(
            data, use_list=use_list, raw=False, strict_map_key=False)


def test_pldata_and_intrinsics_match_jax(recordings, tmp_path):
    """The fixture's gaze.pldata and world.intrinsics: the same topics,
    timestamps and decoded entries as the JAX reader (msgpack); the
    port's writer writes the JAX writer's bytes; nested serialized dicts
    (ext 13) survive; a corrupt stream raises ValueError."""
    eye = recordings[0] / "02EyeTracker" / "001"
    mine, ref = port_fm.load_pldata_file(eye, "gaze"), jax_fm.load_pldata_file(eye, "gaze")
    np.testing.assert_array_equal(mine.timestamps, ref.timestamps)
    assert list(mine.topics) == list(ref.topics)
    assert len(mine.data) == len(ref.data) == 4000
    assert all(dict(a.items()) == dict(b.items()) for a, b in zip(mine.data, ref.data))
    assert port_fm.load_object(eye / "world.intrinsics") == \
        jax_fm.load_object(eye / "world.intrinsics")

    nested = port_fm.Serialized_Dict({"v": 1, "sub": port_fm.Serialized_Dict({"k": [2, 0.5]})})
    ref_nested = jax_fm.Serialized_Dict({"v": 1, "sub": jax_fm.Serialized_Dict({"k": [2, 0.5]})})
    assert nested.serialized == ref_nested.serialized
    back = port_fm.Serialized_Dict(msgpack_bytes=ref_nested.serialized)
    assert back["sub"]["k"] == ref_nested["sub"]["k"] == (2, 0.5)
    plain = [{"topic": "t", "v": i} for i in range(3)]
    port_fm.save_pldata_file(plain, [0.0, 1.0, 2.0], tmp_path / "p2", "t")
    jax_fm.save_pldata_file(plain, [0.0, 1.0, 2.0], tmp_path / "j2", "t")
    assert (tmp_path / "p2" / "t.pldata").read_bytes() == \
        (tmp_path / "j2" / "t.pldata").read_bytes()
    (tmp_path / "p2" / "t.pldata").write_bytes(b"\x92\xa1t\xc4\x10abc")
    with pytest.raises(ValueError):
        port_fm.load_pldata_file(tmp_path / "p2", "t")


# ----------------------------------------------------------------- gaze #

def _gaze_entries(n, seed):
    """Gaze with fixations and saccades: a random walk that jumps every
    ~0.4 s, some samples below the confidence floor."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(np.where(rng.random((n, 2)) < 0.012, rng.normal(0, 0.08, (n, 2)),
                             rng.normal(0, 0.0005, (n, 2))), axis=0) + 0.5
    return [{"norm_pos": (float(x), float(y)), "timestamp": i / 200.0,
             "confidence": float(rng.uniform(0.5, 1.0))} for i, (x, y) in enumerate(pos)]


@pytest.mark.parametrize("seed", [0, 1])
def test_intrinsics_and_fixation_masks_match_jax(recordings, seed):
    """``_resolve_intrinsics`` gives the same camera, and
    ``detect_fixations`` the same mask, as the JAX package."""
    intr = jax_fm.load_object(recordings[0] / "02EyeTracker" / "001" / "world.intrinsics")
    capture = {"intrinsics": intr, "frame_size": (1088, 1080)}
    cam, ref_cam = port_gaze._resolve_intrinsics(capture), jax_gaze._resolve_intrinsics(capture)
    np.testing.assert_array_equal(cam.K, ref_cam.K)
    np.testing.assert_array_equal(cam.D, ref_cam.D)
    gaze = _gaze_entries(1500, seed)
    mine = port_gaze.detect_fixations(capture, gaze)
    ref = jax_gaze.detect_fixations(capture, gaze)
    np.testing.assert_array_equal(mine, ref)
    assert 0 < mine.sum() < len(mine)


# ----------------------------------------------------------- image ops #

CAMERAS = {
    "gopro": (JaxGEM.LEFT_VIDEO_CAMERA_INTRINSICS, JaxGEM.LEFT_VIDEO_DISTORTION_COEFFICIENTS),
    "front": (np.array([[766.0, 0, 544.0], [0, 766.0, 540.0], [0, 0, 1]], np.float32),
              np.array([-0.1, 0.05, 0, 0, 0], np.float32)),
}


@pytest.mark.parametrize("camera,hw", [("gopro", (270, 480)), ("front", (136, 135)),
                                       ("front", (48, 64))])
def test_undistort_and_resize_match_cv2(camera, hw):
    """The numpy remap and resize against the JAX package's cv2 calls on
    seeded frames: within 1, share of exact elements printed; the remap of
    the kept columns equals the crop of the full remap."""
    k, d = CAMERAS[camera]
    frames = np.random.default_rng(3).integers(0, 256, (2,) + hw + (3,), dtype=np.uint8)
    und = port_image.undistort_video_numpy(frames, k, d)
    shares = {"undistort": exact_share(und, jax_image.undistort_video_numpy(frames, k, d))}
    cols = port_image.crop_columns(hw[1])
    np.testing.assert_array_equal(port_image.remap_table(k, d, *hw).apply(frames, cols),
                                  port_image.crop_horizontal(und))
    for scale in (0.1, 0.3, 0.4, 0.5, 0.6):
        out_hw = (max(int(hw[0] * scale), 1), max(int(hw[1] * scale), 1))
        shares[f"resize {scale}"] = exact_share(port_image.resize_video_numpy(und, out_hw),
                                                jax_image.resize_video_numpy(und, out_hw))
    img = frames[0]
    shares["image"] = exact_share(port_image.undistort_image_numpy(img, k, d),
                                  jax_image.undistort_image_numpy(img, k, d))
    print(camera, hw, "exact shares", shares)


# ---------------------------------------------------------------- video #

WINDOWS = [(0.0, 4.0), (2.0, 6.0), (1.0, 5.0), (2.5, 6.5), (0.35, 4.35), (9.0, 13.0),
           (4.0, 8.0), (16.0, 21.0)]


@pytest.mark.parametrize("name", ["left", "world"])
def test_raw_reader_matches_cv2_and_the_frames_written(recordings, name):
    """The port's raw reader against the JAX ``read_video`` (cv2, which
    reads these files here) and against the frames the writer wrote:
    exact, window by window, at the source rate and decimated."""
    path = _files(recordings[1])[name]
    base = port_fixture.video_base((48, 64), 1 if name == "left" else 4)
    assert port_mp4.MP4(path).video_track().codec == "raw "
    for start, end in WINDOWS:
        for fps in (None, 5, 10):
            got = port_video.read_video(path, start, end, fps)
            want = jax_video.read_video(path, start, end, fps)
            np.testing.assert_array_equal(got["video"], want["video"])
            assert got["fps"] == want["fps"] == 30.0
            first = int(start * 30 + 0.5)
            stride = 1 if fps is None else 30 // fps
            written = [port_fixture.video_frame(base, first + stride * j)
                       for j in range(len(got["video"]))]
            np.testing.assert_array_equal(got["video"], np.stack(written))


@pytest.mark.parametrize("kind", ["jax", "raw"])
def test_windowed_reader_matches_jax(recordings, kind):
    """``WindowedVideoReader`` on the mp4v file (cv2) and the raw file:
    the same windows and the same fresh seeks as the JAX reader, with a
    per-frame transform."""
    path = _files(recordings[0 if kind == "jax" else 1])["left"]

    def transform(f):
        return f[:, ::2, ::2] // 2

    mine = port_video.WindowedVideoReader(path, 5, transform, keep_past_sec=6.0)
    ref = jax_video.WindowedVideoReader(path, 5, transform, keep_past_sec=6.0)
    for start, end in WINDOWS + [(w[0] + 0.35, w[1] + 0.35) for w in WINDOWS]:
        np.testing.assert_array_equal(mine.read(start, end)["video"],
                                      ref.read(start, end)["video"])
    assert mine.n_resets == ref.n_resets > 1
    np.testing.assert_array_equal(port_video.read_video(path, 3.0, 7.0, 5)["video"],
                                  jax_video.read_video(path, 3.0, 7.0, 5)["video"])


def test_windowed_reader_memo_transforms_each_frame_once(recordings):
    """Shuffled 14 s windows of the raw file re-seek often; the port's
    memo serves the windows the JAX reader serves while putting each
    source frame through the transform once (the JAX reader: again after
    every fresh seek)."""
    path = _files(recordings[1])["left"]
    calls = {"port": 0, "jax": 0}

    def counted(name):
        def transform(f):
            calls[name] += len(f)
            return f[:, ::4, ::4]
        return transform

    mine = port_video.WindowedVideoReader(path, 5, counted("port"), keep_past_sec=2.0)
    ref = jax_video.WindowedVideoReader(path, 5, counted("jax"), keep_past_sec=2.0)
    kept = set()
    for k in np.random.default_rng(4).permutation(4):
        start = 2.0 * k + 0.35
        got = mine.read(start, start + 14.0 + 1 / 30)["video"]
        np.testing.assert_array_equal(got, ref.read(start, start + 14.0 + 1 / 30)["video"])
        first = int(start * 30 + 0.5)
        kept.update(range(first, first + 6 * len(got), 6))
    assert mine.n_resets == ref.n_resets > 1
    assert calls["port"] < calls["jax"] and calls["port"] <= len(kept) + mine.n_resets


def test_codec_picks_the_decoder(recordings, tmp_path, monkeypatch):
    """Without cv2: a compressed codec raises ImportError naming the codec
    and the file, and a ``GEMDataset`` over it without a sample cache
    raises when built; a raw file still reads; an unreadable file gives an
    empty array (with a warning), as the JAX reader does."""
    mp4v, raw = _files(recordings[0])["left"], _files(recordings[1])["left"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"'mp4v'.*GH010008\.MP4|GH010008\.MP4.*'mp4v'"):
        port_video.read_video(mp4v, 0, 2)
    assert port_video.read_video(raw, 0, 2)["video"].shape == (61, 48, 64, 3)
    bad = tmp_path / "bad.mp4"
    bad.write_bytes(b"not a video")
    assert port_video.read_video(bad, 0, 2)["video"].shape == (0, 0, 0, 3)
    # the dataset refuses the mp4v recording when it is built, before any
    # work, unless a sample cache (built where cv2 runs) may serve it
    from routeformer_torch.io.dataset import GEMDataset

    with pytest.raises(ImportError, match="'mp4v'"):
        GEMDataset(root=recordings[0], split=["001"], min_pci=None)
    GEMDataset(root=recordings[0], split=["001"], min_pci=None, use_cache=True,
               cache_dir=tmp_path / "cache")
    GEMDataset(root=recordings[1], split=["001"], min_pci=None)


# ---------------------------------------------------------------- cache #

def test_sample_cache_round_trip_and_format(tmp_path):
    """A pushed sample fetches back equal (sync and async writes, and
    ``get_or_compute``); the port reads only its own files: a JAX cache
    file in the same directory is never read or touched, and a file
    without the port's magic is a miss and removed."""
    sample = {"train": {"gps": np.arange(6.0).reshape(3, 2),
                        "left_video": np.arange(24, dtype=np.uint8).reshape(1, 2, 4, 3)},
              "pci": 12.5}
    for async_writes in (False, True):
        cache = port_cache.SampleCache(tmp_path / str(async_writes), params_repr="p",
                                       async_writes=async_writes)
        assert cache.fetch("item") is None
        assert cache.push("item", sample)
        cache.flush()
        got = cache.fetch("item")
        np.testing.assert_array_equal(got["train"]["left_video"],
                                      sample["train"]["left_video"])
        np.testing.assert_array_equal(got["train"]["gps"], sample["train"]["gps"])
        assert got["pci"] == 12.5 and cache.size_bytes() > 0
        assert cache.get_or_compute("other", lambda: {"x": 1}) == {"x": 1}
        cache.flush()
        assert cache.get_or_compute("other", lambda: {"x": 2}) == {"x": 1}

    shared = tmp_path / "shared"
    jax_cache.SampleCache(shared, params_repr="p").push("item", {"jax": True})
    zst = list(shared.glob("*.zst"))
    port = port_cache.SampleCache(shared, params_repr="p")
    assert port.fetch("item") is None and list(shared.glob("*.zst")) == zst
    port.push("item", {"port": True})
    assert port.fetch("item") == {"port": True}
    assert jax_cache.SampleCache(shared, params_repr="p").fetch("item") == {"jax": True}
    path = port._path(port.key("item"))
    path.write_bytes(b"\x28\xb5\x2f\xfd" + path.read_bytes()[4:])
    assert port.fetch("item") is None and not path.exists()
