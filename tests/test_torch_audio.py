"""The port's audio decode (``routeformer_torch/io/audio.py``) and
``GEMDataset(with_audio=True)`` against the JAX package's on the CPU.

Limits: every read is the same bytes as JAX ``read_audio``'s (which decodes
PCM with its ffmpeg shim here, and the port with its Python twin); AAC,
where the port's copy of the shim builds, the same bytes as JAX's shim
(the same decoder); the dataset's samples the same keys and bits as the
JAX dataset's."""

import numpy as np
import pytest

from routeformer_torch.io import audio, native
from routeformer_torch.io.dataset import GEMDataset
from routeformer_torch.io.gem_fixture import audio_tone, build_gem_fixture
from routeformer_torch.io.gem_fixture import inject_pcm_audio_track, write_raw_video
from routeformer_torch.io.loader import default_collate
from routeformer_tpu.io import audio as jax_audio
from routeformer_tpu.io.dataset import GEMDataset as JaxGEMDataset
from routeformer_tpu.io.loader import default_collate as jax_collate

RATE = 48000
INF = float("inf")
# Whole file; inside; off-packet start (the preceding chunk prepended);
# a start on a chunk boundary (1024 frames at 48 kHz); zero length; past
# the end; reaching EOF.
WINDOWS = [(0.0, INF), (1.0, 3.0), (2.5, 4.25), (1024 / RATE, 0.5), (1.0, 1.0),
           (7.0, 9.0), (5.9, INF)]


@pytest.fixture(scope="module")
def pcm_mp4(tmp_path_factory):
    path = tmp_path_factory.mktemp("pcm") / "clip.mp4"
    write_raw_video(path, 30, hw=(8, 8))
    pcm = audio_tone(6.0, RATE, seed=5)
    inject_pcm_audio_track(path, pcm, RATE)
    return path, pcm


@pytest.mark.parametrize("window", WINDOWS, ids=[f"{a}-{b}" for a, b in WINDOWS])
def test_pcm_read_matches_jax(pcm_mp4, window):
    """The window semantics, byte for byte; the whole file is the channel
    mean at the int16 scale."""
    path, pcm = pcm_mp4
    got, want = audio.read_audio(path, *window), jax_audio.read_audio(path, *window)
    assert got["sample_rate"] == want["sample_rate"]
    assert got["audio"].dtype == want["audio"].dtype
    np.testing.assert_array_equal(got["audio"], want["audio"])
    if window == (0.0, INF):
        assert got["audio"].shape == (pcm.shape[0], 1) and got["sample_rate"] == RATE
        np.testing.assert_allclose(got["audio"][:, 0], pcm.astype(np.float32).mean(1),
                                   atol=1e-3)
    if window == (2.5, 4.25):  # the preceding chunk: starts at or before 2.5 s
        assert 1.75 * RATE <= got["audio"].shape[0] <= 1.75 * RATE + 3 * 1024


def test_no_track_and_no_file_degrade(tmp_path):
    write_raw_video(tmp_path / "silent.mp4", 4, hw=(8, 8))
    for path in (tmp_path / "silent.mp4", tmp_path / "nope.mp4"):
        assert audio.read_audio(path)["audio"].shape == (0, 0)
        assert jax_audio.read_audio(path)["audio"].shape == (0, 0)


@pytest.fixture(scope="module")
def aac_mp4(tmp_path_factory):
    path = tmp_path_factory.mktemp("aac") / "clip.mp4"
    tone = audio_tone(4.0, RATE, seed=7)[:, 0].astype(np.float32)
    tone /= np.abs(tone).max()
    try:
        audio.encode_aac(path, tone, RATE)
    except ImportError as e:
        pytest.skip(f"the ffmpeg shim does not build here: {e}")
    return path


@pytest.mark.parametrize("window", [(0.0, INF), (0.5, 1.25), (2.37, 3.11), (1.0, 1.0),
                                    (3.9, INF)])
def test_aac_read_matches_jax(aac_mp4, window):
    """AAC through the port's copy of the shim against JAX's: the same
    bytes (the preceding-frame window, a zero-length window that serves
    that frame, a window reaching EOF with the decoder's drained frames)."""
    got, want = audio.read_audio(aac_mp4, *window), jax_audio.read_audio(aac_mp4, *window)
    assert got["sample_rate"] == want["sample_rate"] == RATE
    assert got["audio"].shape[0] >= 1
    np.testing.assert_array_equal(got["audio"], want["audio"])


def test_aac_without_the_library_raises_naming_it(aac_mp4, pcm_mp4, tmp_path, monkeypatch):
    """Where the shim cannot be built (a host without ffmpeg's libraries,
    forced by linking a library that does not exist into a fresh build
    directory), an AAC read raises ImportError naming the libraries before
    any decoding; PCM still reads; a library file that does not load
    raises too."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setitem(native.LINKS, "audio", ["-lrf_no_such_library"])
    with pytest.raises(ImportError, match="librf_no_such_library"):
        audio.read_audio(aac_mp4)
    assert audio.read_audio(pcm_mp4[0])["audio"].shape == (pcm_mp4[1].shape[0], 1)
    monkeypatch.setitem(native.LINKS, "audio", ["-lavformat", "-lavcodec", "-lavutil"])
    bad = native.target("audio")
    bad.parent.mkdir(parents=True, exist_ok=True)
    bad.write_bytes(b"not a library")
    with pytest.raises(ImportError, match="does not load"):
        audio.read_audio(aac_mp4)


@pytest.fixture(scope="module")
def gem_audio_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("gem_audio")
    build_gem_fixture(root, duration_s=18.0, subject="002", turn=1.0, with_audio=True)
    return root


@pytest.mark.parametrize("with_video", [False, True], ids=["audio", "audio+video"])
def test_gem_dataset_with_audio_matches_jax(gem_audio_root, with_video):
    """Two samples of the port's recording with PCM tracks: the same keys
    and the same bits as the JAX dataset's (audio at ``AUDIO_FPS``, split
    into train and target, the three streams one length); their collate
    as the JAX loader's."""
    kw = dict(root=gem_audio_root, split="val", min_pci=None, gopro_scaling_factor=0.5,
              front_scaling_factor=0.5, with_video=with_video, with_audio=True)
    mine, ref = GEMDataset(**kw), JaxGEMDataset(**kw)
    assert len(mine) == len(ref) >= 2
    samples = [mine[i] for i in range(2)]
    for i, got in enumerate(samples):
        want = ref[i]
        for phase in ("train", "target"):
            assert set(got[phase]) == set(want[phase])
            for key, value in want[phase].items():
                np.testing.assert_array_equal(got[phase][key], value, err_msg=key)
        count = mine.input_audio_frame_count
        assert {got["train"][k].shape for k in ("left_audio", "right_audio",
                                                "front_audio")} == {(count, 1)}
    batch, jax_batch = default_collate(samples), jax_collate([ref[i] for i in range(2)])
    for phase in ("train", "target"):
        for key, value in jax_batch[phase].items():
            np.testing.assert_array_equal(batch[phase][key], value, err_msg=key)


def test_ragged_audio_cannot_batch_as_in_jax():
    """The loader stacks audio as the JAX loader does: windows whose audio
    differs in length raise the same ValueError; nothing pads them."""
    samples = [{"left_audio": np.zeros((n, 1), np.float32)} for n in (4, 5)]
    with pytest.raises(ValueError):
        jax_collate(samples)
    with pytest.raises(ValueError):
        default_collate(samples)
