"""The whole slice: the port's ``Routeformer`` eval forward (video + gaze)
against the JAX ``Routeformer`` at the ``test_fusion_parity`` geometry,
with every parameter carried by ``load_flax_params``; and the serving
bundle round trip on the CPU.

Two runs: exhaustive ProbSparse (``u == L`` everywhere, so the key sample
cannot matter) and the real factors (Perceive 5, Informer 4), where the
frame encoder (L = 65) and the video encoder (L = 32) select a strict
subset of queries from the key sample that ``utils/prng.py`` reproduces."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from flax import nnx

from routeformer_tpu.models import RouteformerConfig as JaxConfig
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone import Informer as JaxInformer
from routeformer_tpu.models.gps_backbone import Transformer as JaxTransformer
from routeformer_tpu.models.layers.attention import ProbAttention as JaxProbAttention
from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer
from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_torch import load_serving_bundle, save_serving_bundle
from routeformer_torch.convert import load_flax_params
from routeformer_torch.flagship import init_weights
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig, Transformer
from routeformer_torch.models.layers import ProbAttention
from routeformer_torch.models.video_backbone import TimmBackboneConfig
from test_torch_models import export_params

B, SEQ_LEN, PRED_LEN, GAZE_LEN, IMG = 2, 8, 6, 40, 64
EXHAUSTIVE = 1000  # u = min(factor * ceil(ln L), L) = L everywhere


def _kwargs(gps_factor):
    gps = dict(seq_len=SEQ_LEN, label_len=SEQ_LEN, pred_len=PRED_LEN,
               d_model=32, n_heads=4, e_layers=2, d_layers=1, d_ff=64,
               factor=gps_factor, dropout=0.0, activation="relu", distil=True,
               embed="timeF", freq="m")
    video = dict(model_type="swinv2_parity_test", compute_dtype="float32",
                 pad_to_square=False)
    top = dict(decoder_mode="smart", with_video=True, with_gaze=True,
               dense_prediction=True, image_embedding_size=16,
               encoder_hidden_size=16, encoder_heads=4, encoder_layers=2,
               encoder_d_ff=32, cross_modal_decoder_heads=4,
               cross_modal_decoder_layers=2, feature_dropout=0.0,
               view_dropout=0.0, gaze_dropout=0.0, output_fps=5, video_fps=1,
               gaze_fps=1)
    return gps, video, top


def _port_config(gps_factor=4):
    gps, video, top = _kwargs(gps_factor)
    return RouteformerConfig(
        gps_backbone_config=GPSBackboneConfig(**gps),
        video_backbone_config=TimmBackboneConfig(**video), **top)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    return {
        "gps": np.cumsum(rng.randn(B, SEQ_LEN, 2) * 0.5, axis=1).astype(np.float32),
        "left_video": rng.uniform(size=(B, SEQ_LEN, IMG, IMG, 3)).astype(np.float32),
        "right_video": rng.uniform(size=(B, SEQ_LEN, IMG, IMG, 3)).astype(np.float32),
        "front_video": rng.uniform(size=(B, SEQ_LEN, IMG, IMG, 3)).astype(np.float32),
        "gaze": rng.uniform(size=(B, GAZE_LEN, 2)).astype(np.float32),
    }


@pytest.mark.parametrize("exhaustive", [True, False])
def test_routeformer_eval_forward_matches_jax(rng, exhaustive):
    gps, video, top = _kwargs(EXHAUSTIVE if exhaustive else 4)
    jax_model = JaxRouteformer(
        JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                  video_backbone_config=JaxTimmConfig(cache_enabled=False, **video),
                  **top),
        gps_backbone=JaxInformer, video_backbone=JaxSwin,
        rngs=nnx.Rngs(0, dropout=1),
    )
    port = Routeformer(_port_config(gps["factor"]))
    if exhaustive:
        for _, m in nnx.iter_modules(jax_model):
            if isinstance(m, JaxProbAttention):
                m.factor = EXHAUSTIVE
        for m in port.modules():
            if isinstance(m, ProbAttention):
                m.factor = EXHAUSTIVE
    jax_model.eval()
    port.eval()
    flat = export_params(jax_model, rng)
    n = load_flax_params(port, flat)
    assert n == sum(1 for k in port.state_dict() if "num_batches_tracked" not in k)

    batch = _inputs(7)
    j_gps, j_dense = jax_model({k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        gps_out, dense = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert gps_out.shape == (B, PRED_LEN, 2) and dense.shape == (B, PRED_LEN, 16)
    np.testing.assert_allclose(gps_out.numpy(), np.asarray(j_gps), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dense.numpy(), np.asarray(j_dense), atol=1e-4, rtol=1e-4)


def test_serving_bundle_round_trip(tmp_path):
    model = Routeformer(_port_config())
    init_weights(model, seed=3)
    model.eval()
    batch = _inputs(1)
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in batch.items()})
    save_serving_bundle(tmp_path / "bundle", model)
    serving = load_serving_bundle(tmp_path / "bundle", device="cpu")
    assert not serving.model.training
    got = serving(batch)  # numpy in
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    got_t = serving({k: torch.from_numpy(v) for k, v in batch.items()})  # tensors in
    torch.testing.assert_close(got_t[0], want[0], rtol=0, atol=0)


def test_output_attention_matches_jax(rng):
    """``RouteformerConfig.output_attention`` reaches the GPS backbone:
    ``_forward`` returns the backbone's output and its encoder attention
    maps (the vanilla Transformer's, ``(B, H, L, L)``) as JAX's
    ``_forward`` does; the forward itself returns the prediction alone, as
    in JAX. f32 at 1e-4."""
    gps, _, _ = _kwargs(4)
    gps = dict(gps, seq_len=12, label_len=12)
    top = dict(discount_factor={0: 0.97}, epsilon=1.0, output_attention=True)
    jax_model = JaxRouteformer(JaxConfig(gps_backbone_config=JaxGPSConfig(**gps), **top),
                               gps_backbone=JaxTransformer, rngs=nnx.Rngs(0, dropout=1))
    port = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps), **top),
                       gps_backbone=Transformer)
    assert port.gps_backbone.output_attention
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.eval()
    port.eval()
    batch = {"gps": np.cumsum(rng.normal(size=(B, 12, 2)), axis=1).astype(np.float32)}
    j_dyn, j_vis = jax_model.preprocess_batch({"gps": jnp.asarray(batch["gps"])})
    j_out, j_attn = jax_model._forward(j_dyn, j_vis)
    with torch.no_grad():
        dyn, vis = port.preprocess_batch({"gps": torch.from_numpy(batch["gps"])})
        out, attn = port._forward(dyn, vis)
        pred = port({"gps": torch.from_numpy(batch["gps"])})
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-4, rtol=1e-4)
    assert len(attn) == len(j_attn) == gps["e_layers"]
    for a, w in zip(attn, j_attn):
        assert tuple(a.shape) == w.shape == (B, gps["n_heads"], 12, 12)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    want = np.asarray(jax_model({"gps": jnp.asarray(batch["gps"])}))
    assert isinstance(pred, torch.Tensor)
    np.testing.assert_allclose(pred.numpy(), want, atol=1e-4, rtol=1e-4)
