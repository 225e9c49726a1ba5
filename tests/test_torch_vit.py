"""The port's ViT backbone (``TimmBackbone``/``DinoV2``) and a Routeformer
built on it, against the JAX package on the CPU, with the JAX modules'
parameters carried over by ``load_flax_params`` (the ViT's vmapped
``blocks`` axis unstacked); and a serving bundle that rebuilds the ViT.

Besides ``vit_tiny_test`` (16 tokens), a long-token preset is registered
on both packages: 96 px in patches of 4 gives 576 tokens, so the port's
blocks take K4's route (its plain version on the CPU) while JAX on the CPU
takes its einsum path, which rounds bf16 scores to bf16 where K4 keeps
them in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models import RouteformerConfig as JaxConfig
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone import Informer as JaxInformer
from routeformer_tpu.models.layers.attention import ProbAttention as JaxProbAttention
from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_tpu.models.video_backbone import vit as jax_vit
from routeformer_torch import load_serving_bundle, save_serving_bundle
from routeformer_torch.convert import load_flax_params
from routeformer_torch.flagship import init_weights
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.layers import ProbAttention
from routeformer_torch.models.video_backbone import DinoV2, TimmBackbone, TimmBackboneConfig
from routeformer_torch.models.video_backbone import vit
from routeformer_torch.ops import attention
from test_torch_models import export_params, import_params
from test_torch_routeformer import EXHAUSTIVE, _inputs, _kwargs

LONG = "vit_long_test"


@pytest.fixture
def long_preset(monkeypatch):
    """Register the 576-token preset on both packages; count the port's
    calls into K4's wrapper."""
    monkeypatch.setitem(jax_vit.PRESETS, LONG, jax_vit.ViTPreset(96, 4, 32, 2, 4))
    monkeypatch.setitem(vit.PRESETS, LONG, vit.ViTPreset(96, 4, 32, 2, 4))
    calls = []
    real = attention.dense_attention_blhe
    monkeypatch.setattr(attention, "dense_attention_blhe",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


def perturbed_params(jax_model, rng, noise=0.05) -> dict:
    """``export_params``, and the stacked blocks' biases and norm scales
    perturbed too (their leading depth axis keeps ``export_params`` off)."""
    flat = export_params(jax_model, rng, noise)
    for name, arr in flat.items():
        if "blocks." in name and name.endswith((".bias", ".scale")):
            flat[name] = (arr + noise * rng.normal(size=arr.shape)).astype(np.float32)
    import_params(jax_model, flat)
    return flat


def _vit_pair(rng, kw):
    jax_model = jax_vit.TimmBackbone(JaxTimmConfig(cache_enabled=False, **kw),
                                     rngs=nnx.Rngs(0))
    jax_model.eval()
    flat = perturbed_params(jax_model, rng)
    port = TimmBackbone(TimmBackboneConfig(**kw)).eval()
    assert load_flax_params(port, flat) == len(port.state_dict())
    return jax_model, port, flat


@pytest.mark.parametrize("preset,dtype,hw", [
    ("vit_tiny_test", "float32", (40, 64)),   # pad to square
    ("vit_tiny_test", "float32", (96, 96)),   # antialiased downsampling to 64
    (LONG, "float32", (54, 96)),              # K4 route, pad and upsample
    (LONG, "bfloat16", (54, 96)),             # K4 route, bf16 rounding points
    ("vit_tiny_test", "bfloat16", (64, 64)),  # plain route in bf16
])
def test_vit_backbone_matches_jax(rng, long_preset, preset, dtype, hw):
    """f32 at 1e-4. bf16 is held to the noise floor of bf16 itself, as the
    SwinV2 stage test: the port's mean error against JAX bf16 is at most
    twice JAX bf16's mean error against JAX f32 on the same weights."""
    kw = dict(model_type=preset, compute_dtype=dtype, gelu="exact", pad_to_square=True)
    jax_model, port, flat = _vit_pair(rng, kw)
    x = rng.uniform(size=(3, *hw, 3)).astype(np.float32)
    want = np.asarray(jax_model(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    grid = 24 if preset == LONG else 4
    assert got.shape == want.shape == (3, grid, grid, 32)
    assert long_preset == ([(3, 576, 4, 8)] * 2 if preset == LONG else [])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        return
    jax_f32 = jax_vit.TimmBackbone(
        JaxTimmConfig(cache_enabled=False, **dict(kw, compute_dtype="float32")),
        rngs=nnx.Rngs(0))
    jax_f32.eval()
    import_params(jax_f32, flat)
    floor = np.abs(want - np.asarray(jax_f32(jnp.asarray(x)))).mean()
    assert 0 < np.abs(got - want).mean() <= 2 * floor


def test_vit_presets_and_names():
    """The port's presets are the JAX package's, and timm model strings map
    onto them as in the JAX package."""
    assert ({k: vars(v) for k, v in vit.PRESETS.items()}
            == {k: vars(v) for k, v in jax_vit.PRESETS.items()})
    for name, want in (("vit_base_patch14_dinov2.lvd142m", "dinov2_base"),
                       ("samvit_base_patch16.sa1b", "samvit_base"),
                       ("swinv2_base_window12to16_192to256", "swinv2_base"),
                       ("dinov2_base_224", "dinov2_base_224"), (None, "vit_tiny_test")):
        assert vit.resolve_preset(name) == want
    with pytest.raises(ValueError, match="Unknown"):
        vit.resolve_preset("resnet50")


def _port_config(video, gps_factor):
    gps, _, top = _kwargs(gps_factor)
    return RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                             video_backbone_config=TimmBackboneConfig(**video), **top)


VIDEO = dict(model_type=LONG, compute_dtype="float32", pad_to_square=False)


@pytest.mark.parametrize("exhaustive", [True, False])
def test_routeformer_with_vit_matches_jax(rng, long_preset, exhaustive):
    """The whole eval forward with the long-token ViT as the video backbone
    (K4's route in the port; the frame encoder then sees 577 tokens), f32,
    every parameter carried over: displacement and dense features at
    1e-4. Exhaustive ProbSparse, and the real factors, where the frame
    encoder selects 35 of 577 queries from the key sample."""
    gps, _, top = _kwargs(EXHAUSTIVE if exhaustive else 4)
    jax_model = JaxRouteformer(
        JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                  video_backbone_config=JaxTimmConfig(cache_enabled=False, **VIDEO), **top),
        gps_backbone=JaxInformer, video_backbone=jax_vit.DinoV2,
        rngs=nnx.Rngs(0, dropout=1),
    )
    port = Routeformer(_port_config(VIDEO, gps["factor"]), video_backbone=DinoV2)
    if exhaustive:
        for _, m in nnx.iter_modules(jax_model):
            if isinstance(m, JaxProbAttention):
                m.factor = EXHAUSTIVE
        for m in port.modules():
            if isinstance(m, ProbAttention):
                m.factor = EXHAUSTIVE
    jax_model.eval()
    port.eval()
    flat = perturbed_params(jax_model, rng)
    assert load_flax_params(port, flat) == sum(
        1 for k in port.state_dict() if "num_batches_tracked" not in k)

    batch = _inputs(7)
    j_gps, j_dense = jax_model({k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        gps_out, dense = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(long_preset) == 2  # one K4 call per ViT block
    np.testing.assert_allclose(gps_out.numpy(), np.asarray(j_gps), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dense.numpy(), np.asarray(j_dense), atol=1e-4, rtol=1e-4)


def test_serving_bundle_rebuilds_the_vit(tmp_path):
    """A bundle of a DinoV2-class model loads back as one (not SwinV2) and
    answers the same to the last bit."""
    model = Routeformer(_port_config(dict(VIDEO, model_type="vit_tiny_test"), 4),
                        video_backbone=DinoV2)
    init_weights(model, seed=5)
    model.eval()
    batch = _inputs(2)
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in batch.items()})
    save_serving_bundle(tmp_path / "bundle", model)
    serving = load_serving_bundle(tmp_path / "bundle", device="cpu")
    assert type(serving.model.video_backbone) is DinoV2
    for g, w in zip(serving(batch), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
