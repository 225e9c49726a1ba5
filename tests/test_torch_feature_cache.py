"""The port's feature caches against the JAX package on the CPU: the
content keys and ring slots of the device memo's index, the memo itself
(``DeviceCachedBackbone(device="cpu")``), both batch precomputers, and a
forward on precomputed features against the pixel forward and against
JAX's precomputed forward. The backbone computes in f32 and the caches
store f32 (``cache_dtype="float32"``), so the features are compared at
f32 tolerances."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.io.frame_store import ContentRing as JaxContentRing
from routeformer_tpu.io.frame_store import hash_frames as jax_hash_frames
from routeformer_tpu.models import RouteformerConfig as JaxConfig
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone import Informer as JaxInformer
from routeformer_tpu.models.layers.attention import ProbAttention as JaxProbAttention
from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer
from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_tpu.models.video_backbone import cache as jax_cache
from routeformer_torch.convert import load_flax_params
from routeformer_torch.io.frame_store import ContentRing, hash_frames
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.layers import ProbAttention
from routeformer_torch.models.video_backbone import TimmBackboneConfig
from routeformer_torch.models.video_backbone.cache import (
    DeviceCachedBackbone,
    DeviceVideoFeaturePrecomputer,
    EmbeddingCache,
    VideoFeaturePrecomputer,
    module_content_hash,
)
from test_torch_models import export_params
from test_torch_routeformer import EXHAUSTIVE, _inputs, _kwargs
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

STREAMS = ("left_video", "right_video", "front_video")


@functools.lru_cache(maxsize=None)
def _pair():
    """A JAX model and the port's with its weights (eval mode, exhaustive
    ProbSparse, f32 feature caches)."""
    gps, video, top = _kwargs(EXHAUSTIVE)
    jax_model = JaxRouteformer(
        JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                  video_backbone_config=JaxTimmConfig(cache_enabled=False,
                                                      cache_dtype="float32", **video),
                  **top),
        gps_backbone=JaxInformer, video_backbone=JaxSwin, rngs=nnx.Rngs(0, dropout=1))
    for _, m in nnx.iter_modules(jax_model):
        if isinstance(m, JaxProbAttention):
            m.factor = EXHAUSTIVE
    jax_model.eval()
    flat = export_params(jax_model, np.random.default_rng(0))
    port = Routeformer(RouteformerConfig(
        gps_backbone_config=GPSBackboneConfig(**gps),
        video_backbone_config=TimmBackboneConfig(cache_dtype="float32", **video), **top))
    for m in port.modules():
        if isinstance(m, ProbAttention):
            m.factor = EXHAUSTIVE
    load_flax_params(port, flat)
    return jax_model, port.eval()


def _frames(n, seed=0):
    return np.random.default_rng(seed).uniform(size=(n, 64, 64, 3)).astype(np.float32)


def test_hash_frames_and_ring_match_jax():
    """The same keys; the same slots through resolve/admit/fill, with
    duplicates inside a call, hits across calls and eviction at capacity
    (never of a slot the call references)."""
    frames = _frames(6)
    assert hash_frames(frames) == jax_hash_frames(frames)
    calls = [[0, 1, 1, 2], [2, 3, 0], [4, 5, 3], [1, 0, 5, 4]]
    port, ref = ContentRing(4), JaxContentRing(4)
    keys = hash_frames(frames)
    for call in calls:
        ks = [keys[i] for i in call]
        idx, novel, needed = port.resolve(ks)
        j_idx, j_novel, j_needed = ref.resolve(ks)
        np.testing.assert_array_equal(idx, j_idx)
        assert novel == j_novel and needed == j_needed
        slots = port.admit(list(novel), needed)
        np.testing.assert_array_equal(slots, ref.admit(list(j_novel), j_needed))
        np.testing.assert_array_equal(port.fill(ks, idx), ref.fill(ks, j_idx))
    with pytest.raises(RuntimeError, match="capacity"):
        ContentRing(2).admit(keys[:3], set())
    with pytest.raises(ValueError):
        ContentRing(0)


def test_device_memo_matches_backbone_and_counts_as_jax():
    """Features equal the backbone's own (1e-6); a repeated call encodes
    nothing; ``frames_seen``/``frames_encoded`` follow JAX's memo over the
    same calls; JAX's memo features within 1e-5 of the largest."""
    jax_model, port = _pair()
    bb = port.video_backbone
    memo = DeviceCachedBackbone(bb, bb.configs, device="cpu")
    ref = jax_cache.DeviceCachedBackbone(jax_model.video_backbone,
                                         jax_model.video_backbone.configs)
    frames = _frames(5)
    with torch.no_grad():
        want = bb(torch.from_numpy(frames))
    for call in ([0, 1, 2], [2, 1, 0], [3, 0, 3, 4], [4, 3]):
        got = memo(frames[call])
        j_got = ref(frames[call])
        assert got.shape == (len(call), *bb.output_feature_shape) == j_got.shape
        np.testing.assert_allclose(got.numpy(), want[call].numpy(), rtol=0, atol=1e-6)
        assert (memo.frames_seen, memo.frames_encoded) == (ref.frames_seen,
                                                           ref.frames_encoded)
    assert (memo.frames_seen, memo.frames_encoded) == (12, 5)
    assert memo.capacity == ref.capacity
    j_all = np.asarray(ref(frames))
    np.testing.assert_allclose(memo(frames).numpy(), j_all, rtol=0,
                               atol=1e-5 * np.abs(j_all).max())


def test_embedding_cache_ram_tier(tmp_path):
    """Only missing frames are computed; the byte budget evicts the least
    recently used entry; with a cache directory, a fresh cache (a new run)
    serves every frame from the disk tier, the same bits, computing none."""
    frames = _frames(3)
    calls = []

    def compute(x):
        calls.append(len(x))
        return torch.from_numpy(x.mean(axis=(1, 2)))

    cache = EmbeddingCache(module_hash="m", max_memory_bytes=2 * 3 * 2, dtype="bfloat16")
    first = cache.get_or_compute(frames[:2], compute)
    again = cache.get_or_compute(frames[[1, 0]], compute)
    assert calls == [2] and torch.equal(again, first[[1, 0]])
    cache.get_or_compute(frames[2:], compute)  # evicts frame 1, the least recent
    assert cache.memory_bytes == 12
    cache.get_or_compute(frames[:1], compute)
    assert calls == [2, 1]
    cache.get_or_compute(frames[1:2], compute)
    assert calls == [2, 1, 1]
    disk = EmbeddingCache(cache_dir=str(tmp_path), module_hash="m", dtype="bfloat16")
    stored = disk.get_or_compute(frames, compute)
    assert calls == [2, 1, 1, 3]
    fresh = EmbeddingCache(cache_dir=str(tmp_path), module_hash="m", dtype="bfloat16")
    assert torch.equal(fresh.get_or_compute(frames[::-1], compute), stored.flip(0))
    assert calls == [2, 1, 1, 3]
    assert [p.parent.name for p in tmp_path.rglob("*.rfz")] == ["torch_embcache_m"] * 3


@pytest.mark.parametrize("kind", ["host", "device"])
def test_precomputers_follow_jax_batch_contract(kind):
    """``*_video`` -> ``*_video_features``: the same keys as JAX's, the
    full timeline with zeros where the model samples no frame, features
    within 1e-5 of the largest (the f32 backbones' own distance)."""
    jax_model, port = _pair()
    if kind == "host":
        pre, ref = VideoFeaturePrecomputer(port, device="cpu"), \
            jax_cache.VideoFeaturePrecomputer(jax_model)
    else:
        pre, ref = DeviceVideoFeaturePrecomputer(port, device="cpu"), \
            jax_cache.DeviceVideoFeaturePrecomputer(jax_model)
    batch = _inputs(7)
    got, want = pre(batch), ref(batch)
    assert set(got) == set(want) == {"gps", "gaze", *(s + "_features" for s in STREAMS)}
    for s in STREAMS:
        g, w = got[s + "_features"], np.asarray(want[s + "_features"])
        assert tuple(g.shape) == w.shape
        assert g.dtype == torch.float32
        sampled = np.abs(w).reshape(w.shape[:2] + (-1,)).max(-1) > 0
        assert not g.numpy()[~sampled].any()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    if kind == "device":
        assert pre.stats()["encoded"] == ref.stats()["encoded"]
        pre(batch)
        assert pre.stats()["encoded"] == ref.stats()["encoded"]  # nothing new
        assert pre.stats()["seen"] == 2 * ref.stats()["seen"]


def test_forward_on_precomputed_features():
    """The port's forward on precomputed features equals its pixel forward
    (1e-6) and JAX's forward on its own precomputed features (2e-4, the
    f32 limit of the serving forward's parity test)."""
    jax_model, port = _pair()
    batch = _inputs(7)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    features = DeviceVideoFeaturePrecomputer(port, device="cpu")(batch)
    with torch.no_grad():
        pixel = port(tensors)
        cached = port({k: torch.as_tensor(v) for k, v in features.items()})
    j_features = jax_cache.DeviceVideoFeaturePrecomputer(jax_model)(batch)
    j_out = jax_model({k: jnp.asarray(v) for k, v in j_features.items()})
    for p, c, j in zip(pixel, cached, j_out):
        np.testing.assert_allclose(c.numpy(), p.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(c.numpy(), np.asarray(j), rtol=2e-4, atol=2e-4)


def test_module_content_hash_follows_the_weights():
    _, port = _pair()
    bb = port.video_backbone
    h = module_content_hash(bb)
    assert h == module_content_hash(bb) and len(h) == 40
    other = Routeformer(port.configs).video_backbone
    assert module_content_hash(other) != h
