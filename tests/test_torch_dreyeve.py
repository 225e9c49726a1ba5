"""The port's DR(eye)VE data path against the JAX package's on the CPU:
``routeformer_torch/io/dataset_dreyeve.py`` (the metadata join without
pandas, the window index, PCI and its JSON cache, the balanced bins, items
on both frame routes), its frame decoders (``io/frames.py``) and the
``INTER_AREA`` table (``ops/image.AreaTable``) against cv2, on sessions
written by ``io/dreyeve_fixture.py`` (20 s, 36 x 64 frames, every pandas
trap of the join).

Limits: the join's rows, order and columns exact (f64), the PCHIP-filled
lat/lon within 1e-12 relative; windows and bins exact, PCI within 1e-9;
items the same bits (uint8 and float16 frames, GPS, PCI), gaze within
1e-7; ``INTER_AREA`` and the decoders bit-exact with cv2 5.0. The JAX
dataset's AVI route reads through cv2 in a subprocess (cv2 5.0 aborts the
interpreter on some hand-written AVIs: here it reads the top-down files)."""

import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest

from routeformer_torch.io import frames as F
from routeformer_torch.io.dataset_dreyeve import (
    DreyeveDataset,
    interpolate_linear,
    interpolate_pchip_inside,
    join_session,
)
from routeformer_torch.io.dreyeve_fixture import build_dreyeve_fixture
from routeformer_torch.ops.image import resize_area
from routeformer_tpu.io.dataset_dreyeve import DreyeveDataset as JaxDreyeveDataset

ROOT = Path(__file__).resolve().parents[1]
PCHIP_RTOL = 1e-12
PCI_TOL = 1e-9
GAZE_TOL = 1e-7


@pytest.fixture(scope="module")
def dreyeve_root(tmp_path_factory):
    """Sessions 1 (train) and 45 (val), every trap, with top-down AVIs
    (which cv2 reads)."""
    root = tmp_path_factory.mktemp("dreyeve")
    return build_dreyeve_fixture(root, session_ids=(1, 45), duration_s=20.0,
                                 garmin_hw=(36, 64), etg_hw=(36, 63), avi=True,
                                 avi_top_down=True)


def _kwargs(root, **extra):
    kw = dict(root_dir=root, split=[1, 45], input_length=8, target_length=6, step_size=2,
              min_pci=0, output_fps=5, gopro_scaling_factor=0.4, front_scaling_factor=1 / 3,
              with_video=False)
    kw.update(extra)
    return kw


def _cells(column) -> list:
    """A column's values as Python objects, NaN as None (NaN != NaN)."""
    def norm(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return tuple(norm(x) for x in v)
        if isinstance(v, float) and np.isnan(v):
            return None
        return v.item() if isinstance(v, np.generic) else v
    return [norm(v) for v in column]


def _assert_same_metadata(mine, ref):
    assert len(mine) == len(ref)
    assert list(ref.columns) == list(mine.COLUMNS)
    for col in ref.columns:
        want = ref[col]
        if col in ("lat", "lon"):
            got, exp = mine[col], want.to_numpy()
            np.testing.assert_allclose(got, exp, rtol=PCHIP_RTOL, atol=0, err_msg=col)
            continue
        if want.dtype != object:
            assert mine[col].dtype == want.dtype, col
        assert _cells(mine[col]) == _cells(want.tolist()), col


@pytest.mark.parametrize("session", [1, 45])
def test_metadata_join_matches_jax(dreyeve_root, session):
    """Rows, order and every column of the join, against the JAX dataset's
    pandas join, on a session with NaN tokens of seven spellings, gaps
    inside and at both ends, lone gaze readings and a duplicated GPS
    frame."""
    mine = DreyeveDataset(**_kwargs(dreyeve_root, split=[session]))
    ref = JaxDreyeveDataset(**_kwargs(dreyeve_root, split=[session]))
    assert list(mine.metadata) == list(ref.metadata) == [session]
    _assert_same_metadata(mine.metadata[session], ref.metadata[session])


def test_join_traps_of_group_keys(tmp_path):
    """The groupby traps the fixture cannot hold (the frames would not be
    readable): NaN garmin frame keys (dropped, float keys), unsorted keys,
    a group whose first ETG frame is NaN ("first" skips it), a GPS frame
    with no gaze row and a gaze frame with no GPS row."""
    session = tmp_path / "03"
    session.mkdir()
    (session / "etg_samples.txt").write_text("\n".join([
        "frame_etg frame_gar X Y event_type timestamp",
        "5 2 10.5 20 Fixation 1", "NaN 1 11 21 Saccade 2", "7 1 12 NA Fixation 3",
        "8 NaN 13 23 Fixation 4", "9 0 14 24 None 5", "10 0 15 25 Fixation 6",
        "11 0 16 26 Fixation 7", "12 4 17.25 27 Fixation 8", "13 3 NaN 28 Fixation 9"]))
    (session / "speed_course_coord.txt").write_text("\n".join([
        "0\t1\t10\t45.1\t7.1", "1\tnan\t11\t45.2\t7.2", "2\t3\t\t45.3\t7.3",
        "3\t4\t13\tNULL\t7.4", "4\t5\t14\t45.5\t7.5", "6\t6\t15\t45.6\t7.6"]))
    mine = join_session(session / "etg_samples.txt", session / "speed_course_coord.txt")
    ref = JaxDreyeveDataset(root_dir=tmp_path, split=[3], with_video=False,
                            input_length=1, target_length=1).metadata[3]
    _assert_same_metadata(mine, ref)
    assert mine["frame_gar"].dtype == np.float64 and mine["frame_etg"][1] == 7.0


def test_interpolation_matches_pandas():
    s = pd.Series([np.nan, 1, np.nan, 3, np.nan, np.nan])
    np.testing.assert_array_equal(interpolate_linear(s.to_numpy()), s.interpolate().to_numpy())
    s = pd.Series([np.nan, 1, np.nan, np.nan, 4, 2, np.nan, 7, np.nan])
    np.testing.assert_allclose(interpolate_pchip_inside(s.to_numpy()),
                               s.interpolate(method="pchip", limit_area="inside").to_numpy(),
                               rtol=PCHIP_RTOL, atol=0)


@pytest.mark.parametrize("extra", [{}, {"min_pci": 20.0}, {"min_pci": None, "max_pci": 30.0},
                                   {"min_pci": 1e9}],
                         ids=["all", "min_pci", "max_pci", "none_left"])
def test_index_and_pci_match_jax(dreyeve_root, extra):
    mine = DreyeveDataset(**_kwargs(dreyeve_root, **extra))
    ref = JaxDreyeveDataset(**_kwargs(dreyeve_root, **extra))
    key = [(e["session_id"], e["start_index"], e["seq_length"], e["fps_divisor"])
           for e in ref.data]
    assert [(e["session_id"], e["start_index"], e["seq_length"], e["fps_divisor"])
            for e in mine.data] == key
    np.testing.assert_allclose([e["pci"] for e in mine.data], [e["pci"] for e in ref.data],
                               rtol=0, atol=PCI_TOL)
    assert len(mine) == len(ref)


def test_pci_json_is_read_by_either_package(dreyeve_root, tmp_path):
    """Each package reads the PCI file the other wrote (the JAX layout,
    ``dreyeve_dataset/pci_stepsize-2.json``) and rebuilds nothing."""
    for writer, reader, name in ((DreyeveDataset, JaxDreyeveDataset, "port"),
                                 (JaxDreyeveDataset, DreyeveDataset, "jax")):
        cache = tmp_path / name
        first = writer(**_kwargs(dreyeve_root, use_cache=True, cache_dir=cache))
        path = cache / "dreyeve_dataset" / "pci_stepsize-2.json"
        written = json.loads(path.read_text())
        assert set(written) == {"version", "seq_length_full", "step_size", "pci"}
        assert written["seq_length_full"] == 420 and written["step_size"] == 60
        stamp = path.stat().st_mtime_ns
        second = reader(**_kwargs(dreyeve_root, use_cache=True, cache_dir=cache))
        assert path.stat().st_mtime_ns == stamp, f"{reader.__module__} rewrote {name}'s file"
        assert [e["pci"] for e in second.data] == [e["pci"] for e in first.data]


@pytest.mark.parametrize("split", ["train", "val"])
def test_balanced_bins_match_jax(dreyeve_root, split):
    """The PCI-balanced bins (train: every entry, a fixed epoch; val: each
    bin cut to the smallest): the same entries in the same order (the JAX
    dataset shuffles with the seeded global ``random``, the port with its
    own ``random.Random(seed)``), and the same entry behind every index."""
    kw = _kwargs(dreyeve_root, split=split, enable_pci_split=True,
                 pci_split_n_samples_per_bin=2)
    mine, ref = DreyeveDataset(**kw), JaxDreyeveDataset(**kw)

    def bins(ds):
        return {k: [(e["session_id"], e["start_index"]) for e in v]
                for k, v in ds.data_bins.items()}

    assert bins(mine) == bins(ref) and len(ref.data_bins) > 1
    assert mine.data_bins_keys == ref.data_bins_keys
    assert mine.bin_epoch_size == ref.bin_epoch_size and len(mine) == len(ref)
    for i in range(len(ref)):
        a, b = mine.entry(i), ref.get_with_info(i)[1]
        assert (a["session_id"], a["start_index"]) == (b["session_id"], b["start_index"])


def _assert_same_items(mine: list, ref: list):
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert abs(a["pci"] - b["pci"]) <= PCI_TOL
        for phase in ("train", "target"):
            assert sorted(a[phase]) == sorted(b[phase])
            for key, want in b[phase].items():
                got = a[phase][key]
                assert got.dtype == want.dtype and got.shape == want.shape, (phase, key)
                if key == "gaze":
                    np.testing.assert_allclose(got, want, rtol=0, atol=GAZE_TOL)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=f"{phase}.{key}")


@pytest.mark.parametrize("video_dtype", ["uint8", "float16"])
def test_items_from_frames_match_jax(dreyeve_root, video_dtype):
    """``__getitem__`` on the frame-file route (BMP content, read by cv2 in
    the JAX package), cropped, at the driver's scaling 0.4 and 1/3."""
    kw = _kwargs(dreyeve_root, with_video=True, video_dtype=video_dtype)
    mine, ref = DreyeveDataset(**kw), JaxDreyeveDataset(**kw)
    _assert_same_items([mine[i] for i in range(len(mine))], [ref[i] for i in range(len(ref))])
    assert mine[0]["train"]["left_video"].shape == (40, 7, 25, 3)


_JAX_AVI_ITEMS = r"""
import sys, pickle
import jax
jax.config.update("jax_platforms", "cpu")
from routeformer_tpu.io.dataset_dreyeve import DreyeveDataset
kw = pickle.loads(bytes.fromhex(sys.argv[1]))
ds = DreyeveDataset(**kw)
with open(sys.argv[2], "wb") as f:
    pickle.dump([ds[i] for i in range(len(ds))], f)
"""


def test_items_from_avi_match_jax(dreyeve_root, tmp_path):
    """``use_frames=False``: the port's raw AVI reader against the JAX
    dataset's cv2 decode (in a subprocess), and against the frame route."""
    import pickle

    kw = _kwargs(dreyeve_root, with_video=True, use_frames=False, video_dtype="uint8")
    mine = DreyeveDataset(**kw)
    items = [mine[i] for i in range(len(mine))]
    out = tmp_path / "items.pkl"
    run = subprocess.run([sys.executable, "-c", _JAX_AVI_ITEMS, pickle.dumps(kw).hex(),
                          str(out)], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(out, "rb") as f:
        _assert_same_items(items, pickle.load(f))
    frames = DreyeveDataset(**dict(kw, use_frames=True))
    _assert_same_items(items, [frames[i] for i in range(len(frames))])


def test_sample_and_memory_caches_serve_the_same_items(dreyeve_root, tmp_path):
    """A second dataset serves every item from the zlib sample cache (its
    reader removed); the memory tier serves read-only arrays, a fresh dict
    nesting each time (as in the JAX dataset, a sample-cache hit does not
    fill it)."""
    kw = _kwargs(dreyeve_root, with_video=True, video_dtype="uint8", use_cache=True,
                 cache_dir=tmp_path)
    first = DreyeveDataset(**kw)
    want = [first[i] for i in range(len(first))]
    first._sample_cache.flush()
    assert list((tmp_path / "dreyeve_dataset" / "torch_items").glob("*.rfz"))
    cached = DreyeveDataset(**kw)
    cached._get_uncached_item = None  # every item must come from the sample cache
    _assert_same_items([cached[i] for i in range(len(cached))], want)
    memory = DreyeveDataset(**dict(kw, use_cache=False, use_memory_cache=True))
    _assert_same_items([memory[i] for i in range(len(memory))], want)
    hit = memory[0]
    assert 0 in memory.full_dataset and hit is not memory.full_dataset[0]
    assert hit["train"]["gps"] is memory.full_dataset[0]["train"]["gps"]
    with pytest.raises(ValueError):
        hit["train"]["gps"][...] = 0


@pytest.mark.parametrize("hw,scale", [((108, 192), 0.4), ((96, 144), 1 / 3), ((37, 61), 0.55),
                                      ((38, 70), 0.5), ((540, 960), 0.8)],
                         ids=["garmin_0.4", "etg_1/3", "odd", "box_2", "smoke_garmin"])
def test_inter_area_matches_cv2(hw, scale):
    """The general area-weight path (0.4, 0.55, 0.8), the integer box
    (1/3) and the (sum + 2) >> 2 box (1/2): bit-exact."""
    img = np.random.default_rng(7).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = cv2.resize(img, (int(hw[1] * scale), int(hw[0] * scale)),
                      interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(resize_area(img, scale), want)


_CV2_AVI = r"""
import sys, cv2, numpy as np
cap = cv2.VideoCapture(sys.argv[1])
frames = []
while True:
    ok, bgr = cap.read()
    if not ok:
        break
    frames.append(bgr[..., ::-1])
np.save(sys.argv[2], np.stack(frames))
"""


@pytest.mark.parametrize("width", [61, 64])
def test_frame_decoders_match_cv2(tmp_path, width):
    """BMP (bottom-up and top-down, padded rows) and binary PPM under
    ``.jpg`` names against ``cv2.imread``; the raw AVI reader against cv2
    (top-down, in a subprocess) and against the frames it was written
    from (bottom-up); a JPEG goes through cv2."""
    rng = np.random.default_rng(width)
    img = rng.integers(0, 256, (37, width, 3), dtype=np.uint8)
    for top_down in (False, True):
        F.write_bmp(tmp_path / "a.jpg", img, top_down=top_down)
        assert F.frame_format(tmp_path / "a.jpg") == F.BMP
        np.testing.assert_array_equal(F.read_frame(tmp_path / "a.jpg"),
                                      cv2.imread(str(tmp_path / "a.jpg"))[..., ::-1])
    assert cv2.imwrite(str(tmp_path / "b.ppm"), img[..., ::-1])
    (tmp_path / "b.ppm").rename(tmp_path / "b.jpg")
    assert F.frame_format(tmp_path / "b.jpg") == F.PPM
    np.testing.assert_array_equal(F.read_frame(tmp_path / "b.jpg"), img)
    assert cv2.imwrite(str(tmp_path / "c.jpg"), img[..., ::-1])
    assert F.frame_format(tmp_path / "c.jpg") == F.OTHER
    np.testing.assert_array_equal(F.read_frame(tmp_path / "c.jpg"),
                                  cv2.imread(str(tmp_path / "c.jpg"))[..., ::-1])

    video = [rng.integers(0, 256, (37, width, 3), dtype=np.uint8) for _ in range(5)]
    for top_down in (False, True):
        F.write_avi(tmp_path / "v.avi", video, top_down=top_down)
        with F.AviReader(tmp_path / "v.avi") as reader:
            assert (len(reader), reader.raw, reader.codec, reader.fps) == (5, True, "BI_RGB", 30)
            for i, frame in enumerate(video):
                np.testing.assert_array_equal(reader.frame(i), frame)
    run = subprocess.run([sys.executable, "-c", _CV2_AVI, str(tmp_path / "v.avi"),
                          str(tmp_path / "v.npy")], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    np.testing.assert_array_equal(np.load(tmp_path / "v.npy"), np.stack(video))


def test_decoders_raise_without_cv2(dreyeve_root, tmp_path, monkeypatch):
    """With cv2 blocked: a JPEG frame raises ``ImportError`` naming the file
    and cv2, when read and when a dataset of such frames is built; a
    compressed AVI likewise; BMP frames and raw AVIs read as before."""
    img = np.random.default_rng(0).integers(0, 256, (16, 24, 3), dtype=np.uint8)
    assert cv2.imwrite(str(tmp_path / "x.jpg"), img)
    writer = cv2.VideoWriter(str(tmp_path / "m.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 30,
                             (24, 16))
    writer.write(img)
    writer.release()
    session = tmp_path / "root" / "01"
    (session / "video_garmin_frames").mkdir(parents=True)
    (session / "video_etg_frames").mkdir()
    for name in ("etg_samples.txt", "speed_course_coord.txt"):
        (session / name).write_text((dreyeve_root / "01" / name).read_text())
    for i in range(600):
        for stream in ("garmin", "etg"):
            (session / f"video_{stream}_frames" / f"{i:06d}.jpg").write_bytes(
                (tmp_path / "x.jpg").read_bytes())

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"x\.jpg.*cv2"):
        F.read_frame(tmp_path / "x.jpg")
    with pytest.raises(ImportError, match=r"m\.avi.*cv2"):
        F.read_avi_frames(tmp_path / "m.avi", [0])
    with pytest.raises(ImportError, match=r"video_garmin_frames/\d{6}\.jpg.*cv2"):
        DreyeveDataset(**_kwargs(tmp_path / "root", split=[1], with_video=True))
    item = DreyeveDataset(**_kwargs(dreyeve_root, split=[1], with_video=True,
                                    use_frames=False))[0]
    assert item["train"]["front_video"].shape == (40, 12, 21, 3)
