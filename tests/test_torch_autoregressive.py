"""The autoregressive decode and its loss against the JAX package on the
CPU: the eval forward of an autoregressive Routeformer with video (dense
features re-fed) and without (the Informer alone), at the real ProbSparse
factors (the fixed eval key sample of ``utils/prng.py``), f32 at atol/rtol
1e-4; the training loss's slicing to the first ``autoregressive_step_size``
steps against ``routeformer_tpu/train/losses.py``; and the port's
Monte-Carlo eval of an autoregressive video model: reproducible, and
leaving the model as it found it."""

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
from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_tpu.train.losses import routeformer_training_loss as jax_loss
from routeformer_torch.convert import load_flax_params
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.layers import ProbAttention
from routeformer_torch.models.video_backbone import TimmBackboneConfig
from routeformer_torch.train.losses import TrainingLosses, routeformer_training_loss
from routeformer_torch.train.trainer import ParallelTrainer
from routeformer_torch.optimizers import build_optimizer
from test_torch_models import export_params
from test_torch_routeformer import B, EXHAUSTIVE, PRED_LEN, _inputs, _kwargs
from test_torch_train import OPT, SCHEDULE
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

STEP = 4  # two chunks over PRED_LEN = 6, the second cut to 2
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(rng, video, factor=4, **top_kw):
    gps, video_kw, top = _kwargs(factor)
    top = dict(top, autoregressive=True, autoregressive_step_size=STEP,
               discount_factor=SCHEDULE, epsilon=1.0, visual_epsilon=0.3, **top_kw)
    if video:
        jax_cfg = JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                            video_backbone_config=JaxTimmConfig(cache_enabled=False,
                                                                **video_kw), **top)
        cfg = RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                                video_backbone_config=TimmBackboneConfig(**video_kw), **top)
        jax_model = JaxRouteformer(jax_cfg, gps_backbone=JaxInformer, video_backbone=JaxSwin,
                                   rngs=nnx.Rngs(1, dropout=1001))
    else:
        top = {k: top[k] for k in ("decoder_mode", "autoregressive", "autoregressive_step_size",
                                   "discount_factor", "epsilon")}
        jax_cfg = JaxConfig(gps_backbone_config=JaxGPSConfig(**gps), **top)
        cfg = RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps), **top)
        jax_model = JaxRouteformer(jax_cfg, gps_backbone=JaxInformer,
                                   rngs=nnx.Rngs(7, dropout=1007))
    port = Routeformer(cfg)
    if factor == EXHAUSTIVE:
        for _, m in nnx.iter_modules(jax_model):
            if isinstance(m, JaxProbAttention):
                m.factor = EXHAUSTIVE
        for m in port.modules():
            if isinstance(m, ProbAttention):
                m.factor = EXHAUSTIVE
    load_flax_params(port, export_params(jax_model, rng))
    return jax_model, port


@pytest.mark.parametrize("video", [True, False], ids=["video", "gps-only"])
def test_autoregressive_eval_matches_jax(rng, video):
    jax_model, port = _pair(rng, video)
    jax_model.eval()
    port.eval()
    batch = _inputs(7) if video else {"gps": _inputs(7)["gps"]}
    want = jax_model({k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    assert port.gps_backbone.pred_len == PRED_LEN  # restored after the decode
    if video:
        (gps, dense), (j_gps, j_dense) = got, want
        assert dense.shape == (B, PRED_LEN, 16)
        np.testing.assert_allclose(dense.numpy(), np.asarray(j_dense), **TOL)
    else:
        gps, j_gps = got, want
    assert gps.shape == (B, PRED_LEN, 2)
    np.testing.assert_allclose(gps.numpy(), np.asarray(j_gps), **TOL)
    # the decode differs from one full-horizon forward
    port.configs.autoregressive = False
    with torch.no_grad():
        plain = port({k: torch.from_numpy(v) for k, v in batch.items()})
    plain_gps = plain[0] if video else plain
    assert not torch.allclose(plain_gps, gps, atol=1e-3)


@pytest.mark.parametrize("epoch", [3, 12])
def test_autoregressive_loss_matches_jax(rng, epoch):
    """Train mode, exhaustive ProbSparse and no dropout, so both packages
    run the same full-horizon forward: the loss on the first ``STEP``
    steps, the trajectory loss scaled by ``PRED_LEN / STEP``, the dense
    loss weighted from epoch 10."""
    jax_model, port = _pair(rng, video=True, factor=EXHAUSTIVE)
    jax_model.train()
    port.train()
    inp = _inputs(11)
    tgt = {k: v if k == "gaze" else v[:, :PRED_LEN] for k, v in _inputs(12).items()}
    j_total, j_metrics = jax_loss(jax_model, {k: jnp.asarray(v) for k, v in inp.items()},
                                  {k: jnp.asarray(v) for k, v in tgt.items()}, epoch)
    total, metrics = routeformer_training_loss(
        port, {k: torch.from_numpy(v) for k, v in inp.items()},
        {k: torch.from_numpy(v) for k, v in tgt.items()}, epoch)
    assert set(metrics) == set(j_metrics) == {"loss", "dense_loss", "ade", "fde"}
    assert total.item() == pytest.approx(float(j_total), rel=1e-5)
    for k, v in j_metrics.items():
        assert metrics[k].item() == pytest.approx(float(v), rel=1e-5), k
    # the slicing: the trajectory loss of the first STEP steps, scaled
    with torch.no_grad():
        future, _ = port({k: torch.from_numpy(v) for k, v in inp.items()})
    assert future.shape[1] == PRED_LEN
    want = TrainingLosses.from_config(port.configs).trajectory_loss(
        future[:, :STEP], torch.from_numpy(tgt["gps"])[:, :STEP], epoch) * (PRED_LEN / STEP)
    assert metrics["loss"].item() == pytest.approx(want.item(), rel=1e-6)
    assert (total.item() == pytest.approx(metrics["loss"].item())) == (epoch < 10)


def test_autoregressive_mc_eval_is_reproducible_and_leaks_nothing():
    """The port's counterpart of ``tests/test_trainer.py``'s autoregressive
    MC eval: one train step, then two evaluations of the same batches give
    the same bits and finite ADEs; the backbone's ``pred_len``, the train
    mode and the ProbSparse generators are as before each evaluation."""
    torch.manual_seed(0)
    gps, video_kw, top = _kwargs(4)
    cfg = RouteformerConfig(
        gps_backbone_config=GPSBackboneConfig(**gps),
        video_backbone_config=TimmBackboneConfig(**video_kw),
        **dict(top, autoregressive=True, autoregressive_step_size=STEP,
               discount_factor=SCHEDULE, epsilon=1.0, visual_epsilon=0.3))
    model = Routeformer(cfg)
    trainer = ParallelTrainer({"autoreg": model}, lambda m: build_optimizer(m, **OPT), cfg,
                              device="cpu", unfreeze_epoch=None)

    def batch(seed):
        tgt = {k: v if k == "gaze" else v[:, :PRED_LEN] for k, v in _inputs(seed + 1).items()}
        return {"train": _inputs(seed), "target": tgt,
                "pci": np.asarray([30.0, 60.0], np.float32)}

    trainer.training_step(batch(3))
    val = [batch(5), batch(9)]
    first = trainer.evaluate(val)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    second = trainer.evaluate(val)
    assert first.keys() == second.keys()
    for k in first:
        assert torch.equal(first[k], second[k]), k
    ade = [k for k in first if k.endswith("_ade")]
    assert ade and all(np.isfinite(float(first[k])) for k in ade)
    assert model.training and model.gps_backbone.pred_len == PRED_LEN
    assert all(m.mc_generator is None for m in model.modules() if isinstance(m, ProbAttention))
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
