"""The external baselines of the driver's zoo against the JAX package on
the CPU, in eval mode, f32 at atol/rtol 1e-4, every parameter carried by
``load_flax_params`` (the latent arrays, AutoBot's ``Q`` and ``P`` and the
``nnx.List`` indices included): AutoBotEgo (modes and probabilities) and
AutoBotAdapted, AdaptedGIMO and MultiModalTransformer over the small SwinV2
of ``test_torch_routeformer.py`` with the real ProbSparse factor in their
frame encoders (the key sample of ``utils/prng.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.baselines import AdaptedGIMO as JaxGIMO
from routeformer_tpu.baselines import AutoBotAdapted as JaxAutoBotAdapted
from routeformer_tpu.baselines import AutoBotEgo as JaxAutoBotEgo
from routeformer_tpu.baselines import MultiModalTransformer as JaxMMT
from routeformer_tpu.models import RouteformerConfig as JaxConfig
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_torch.baselines import (
    AdaptedGIMO,
    AutoBotAdapted,
    AutoBotEgo,
    MultiModalTransformer,
)
from routeformer_torch.convert import load_flax_params
from routeformer_torch.models import RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.video_backbone import TimmBackboneConfig
from test_torch_models import export_params
from test_torch_routeformer import B, PRED_LEN, SEQ_LEN, _inputs, _kwargs
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(video):
    gps, video_kw, top = _kwargs(4)
    top = dict(top, dense_prediction=False)
    if not video:
        return (JaxConfig(gps_backbone_config=JaxGPSConfig(**gps), encoder_hidden_size=16,
                          encoder_heads=4, encoder_d_ff=32),
                RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                                  encoder_hidden_size=16, encoder_heads=4, encoder_d_ff=32))
    return (JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                      video_backbone_config=JaxTimmConfig(cache_enabled=False, **video_kw),
                      **top),
            RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                              video_backbone_config=TimmBackboneConfig(**video_kw), **top))


def _load(jax_model, port, rng):
    jax_model.eval()
    port.eval()
    n = load_flax_params(port, export_params(jax_model, rng))
    assert n == sum(1 for k in port.state_dict() if "num_batches_tracked" not in k)


def test_autobot_ego_matches_jax(rng):
    kw = dict(d_k=32, c=5, T=PRED_LEN, L_enc=2, dropout=0.0, k_attr=2, num_heads=4,
              L_dec=2, tx_hidden_size=48)
    jax_model = JaxAutoBotEgo(**kw, rngs=nnx.Rngs(0, dropout=1))
    port = AutoBotEgo(**kw)
    _load(jax_model, port, rng)
    assert {"Q", "P", "temporal_attn_layers.1.attn.wq.weight"} <= set(port.state_dict())
    x = np.random.RandomState(3).randn(B, SEQ_LEN, 3).astype(np.float32)
    j_dists, j_probs = jax_model(jnp.asarray(x))
    with torch.no_grad():
        dists, probs = port(torch.from_numpy(x))
    assert dists.shape == (5, PRED_LEN, B, 5) and probs.shape == (B, 5)
    np.testing.assert_allclose(dists.numpy(), np.asarray(j_dists), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs), **TOL)


def test_autobot_adapted_matches_jax(rng):
    jax_cfg, cfg = _configs(video=False)
    jax_model = JaxAutoBotAdapted(jax_cfg, rngs=nnx.Rngs(6, dropout=1006))
    port = AutoBotAdapted(cfg)
    _load(jax_model, port, rng)
    gps = _inputs(5)["gps"]
    want = jax_model({"gps": jnp.asarray(gps)})
    with torch.no_grad():
        got = port({"gps": torch.from_numpy(gps)})
    assert got.shape == (B, PRED_LEN, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["gimo", "multimodal_transformer"])
def test_video_baselines_match_jax(rng, name):
    jax_cls, port_cls = {"gimo": (JaxGIMO, AdaptedGIMO),
                         "multimodal_transformer": (JaxMMT, MultiModalTransformer)}[name]
    jax_cfg, cfg = _configs(video=True)
    jax_model = jax_cls(jax_cfg, video_backbone=JaxSwin, rngs=nnx.Rngs(3, dropout=1003))
    port = port_cls(cfg)
    _load(jax_model, port, rng)
    if name == "gimo":
        assert {"motion_encoder.latent", "gaze_motion_decoder.query_latent",
                "output_encoder.self_att.1.attn.wq.weight"} <= set(port.state_dict())
    batch = _inputs(7)
    want = jax_model({k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B, PRED_LEN, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_load_flax_params_refuses_an_unmatched_parameter(rng):
    jax_cfg, cfg = _configs(video=False)
    jax_model = JaxAutoBotAdapted(jax_cfg, rngs=nnx.Rngs(6, dropout=1006))
    flat = export_params(jax_model, rng)
    port = AutoBotAdapted(cfg)
    with pytest.raises(KeyError, match="flax-only"):
        load_flax_params(port, dict(flat, **{"model.extra": np.zeros(3, np.float32)}))
    with pytest.raises(KeyError, match="port-only"):
        load_flax_params(port, {k: v for k, v in flat.items() if not k.endswith(".Q")})
