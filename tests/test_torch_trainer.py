"""The port's lockstep trainer against the JAX package's on the CPU.

A ``ParallelTrainer`` over {a small Routeformer (the SwinV2 config of
``test_torch_routeformer.py``, exhaustive ProbSparse, dropout 0, no motion
noise), ``stationary_baseline``} in each package, from the same weights
(``load_flax_params``), takes two steps on the same batches (the first at
epoch 3, the dense loss weighted 0; the second at epoch 12, the dense loss
on and the schedule's second discount), with the Perceive stacks plain and
fused (``ROUTEFORMER_FUSION_KERNEL=interpret``: the JAX Pallas kernels in
interpret mode, the port's plain versions); with the plain stacks it then
evaluates two batches with the Monte-Carlo protocol. Both trainers keep
the backbone frozen (``unfreeze_epoch=None``): the JAX trainer recompiles
its step at the unfreeze, which would double the file's time, and the
port's backbone gradient is held against ``jax.grad`` in
``test_torch_kernels.py``; the boundary itself is tested below. A third
case trains one model of each class the driver's zoo adds side by side
against the JAX trainer. Then the port alone: MC eval reproducibility, the
unfreeze boundary, the refusals, ``fit`` and ``maybe_split_video``."""

import functools

import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models import RouteformerConfig as JaxConfig
from routeformer_tpu.models.cross_modal import PerceiveEncoder as JaxPerceiveEncoder
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone import Informer as JaxInformer
from routeformer_tpu.models.gps_backbone import StationaryBaseline as JaxStationary
from routeformer_tpu.models.layers.attention import ProbAttention as JaxProbAttention
from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer
from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_tpu.optimizers import build_optimizer as jax_build_optimizer
from routeformer_tpu.train.trainer import ParallelTrainer as JaxTrainer
from routeformer_torch.convert import load_flax_params
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig, StationaryBaseline
from routeformer_torch.models.layers import ProbAttention
from routeformer_torch.models.video_backbone import SwinV2Backbone, TimmBackboneConfig
from routeformer_torch.optimizers import build_optimizer
from routeformer_torch.train.trainer import (
    EVAL_SEED,
    ParallelTrainer,
    maybe_split_video,
    set_mc_sampling,
)
from test_torch_models import export_params
from test_torch_routeformer import EXHAUSTIVE, PRED_LEN, _inputs, _kwargs
from test_torch_train import OPT, SCHEDULE, _flat_torch

EPOCHS = (3, 12)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test: the suite runs several workers on a few
    cores, where more threads on these small tensors only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, pci):
    tgt = {k: v if k == "gaze" else v[:, :PRED_LEN] for k, v in _inputs(seed + 1).items()}
    return {"train": _inputs(seed), "target": tgt, "pci": np.asarray(pci, np.float32)}


TRAIN = [_batch(7, [30.0, 30.0]), _batch(11, [30.0, 30.0])]
VAL = [_batch(21, [23.0, 70.0]), _batch(31, [45.0, 90.0])]


def _configs(factor=EXHAUSTIVE, **top_kw):
    gps, video, top = _kwargs(factor)
    top = dict(top, discount_factor=SCHEDULE, epsilon=1.0, visual_epsilon=0.3, **top_kw)
    return gps, video, top


def port_models(factor=EXHAUSTIVE, **top_kw):
    gps, video, top = _configs(factor, **top_kw)
    model = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                                          video_backbone_config=TimmBackboneConfig(**video),
                                          **top))
    if factor == EXHAUSTIVE:
        for m in model.modules():
            if isinstance(m, ProbAttention):
                m.factor = EXHAUSTIVE
    baseline = Routeformer(
        RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                          discount_factor=SCHEDULE, epsilon=1.0),
        gps_backbone=StationaryBaseline)
    return {"routeformer": model, "stationary_baseline": baseline}


def port_trainer(models, **kw):
    return ParallelTrainer(models, lambda m: build_optimizer(m, **OPT),
                           models["routeformer"].configs, device="cpu", **kw)


def _zero_dropout(model):
    """GIMO's fusion FFN keeps a dropout of 0.1 whatever the config; the
    lockstep comparison runs every dropout at 0 in both packages."""
    if isinstance(model, torch.nn.Module):
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    else:
        for _, m in nnx.iter_modules(model):
            if isinstance(m, nnx.Dropout):
                m.rate = 0.0


def _zoo_specs():
    """One model of each class the driver's zoo adds: ``(name, JAX class,
    port class, backbone kind, config builder)``."""
    from routeformer_tpu.baselines import AdaptedGIMO as JaxGIMO
    from routeformer_tpu.baselines import AutoBotAdapted as JaxAutoBot
    from routeformer_tpu.baselines import MultiModalTransformer as JaxMMT
    from routeformer_tpu.models.gps_backbone import DLinear as JaxDLinear
    from routeformer_tpu.models.gps_backbone import LinearBackboneConfig as JaxLinearConfig
    from routeformer_tpu.models.gps_backbone import NLinear as JaxNLinear
    from routeformer_tpu.models.gps_backbone import PatchTST as JaxPatchTST
    from routeformer_tpu.models.gps_backbone import PatchTSTBackboneConfig as JaxPatchConfig
    from routeformer_tpu.models.gps_backbone import Transformer as JaxTransformer
    from routeformer_torch.baselines import AdaptedGIMO, AutoBotAdapted, MultiModalTransformer
    from routeformer_torch.models.gps_backbone import (
        DLinear,
        LinearBackboneConfig,
        NLinear,
        PatchTST,
        PatchTSTBackboneConfig,
        Transformer,
    )

    gps, video, top = _configs()
    gps_top = {k: top[k] for k in ("decoder_mode", "discount_factor", "epsilon")}
    return [
        ("transformer", (JaxRouteformer, JaxTransformer, JaxGPSConfig),
         (Routeformer, Transformer, GPSBackboneConfig), gps_top, {}),
        ("dlinear", (JaxRouteformer, JaxDLinear, JaxLinearConfig),
         (Routeformer, DLinear, LinearBackboneConfig), gps_top, {}),
        ("nlinear", (JaxRouteformer, JaxNLinear, JaxLinearConfig),
         (Routeformer, NLinear, LinearBackboneConfig), gps_top, {"individual": True}),
        ("patchtst", (JaxRouteformer, JaxPatchTST, JaxPatchConfig),
         (Routeformer, PatchTST, PatchTSTBackboneConfig), top, {}),
        ("autobot", (JaxAutoBot, None, JaxGPSConfig), (AutoBotAdapted, None, GPSBackboneConfig),
         dict(gps_top, encoder_hidden_size=16, encoder_heads=4, encoder_d_ff=32), {}),
        ("gimo", (JaxGIMO, None, JaxGPSConfig), (AdaptedGIMO, None, GPSBackboneConfig),
         dict(top, dense_prediction=False), {}),
        ("multimodal_transformer", (JaxMMT, None, JaxGPSConfig),
         (MultiModalTransformer, None, GPSBackboneConfig), dict(top, dense_prediction=False), {}),
    ]


def _zoo_models(jax_side: bool, seed: int = 0):
    gps, video, _ = _configs()
    models = {}
    for i, (name, jax_spec, port_spec, top, gps_kw) in enumerate(_zoo_specs()):
        cls, backbone, gps_cls = jax_spec if jax_side else port_spec
        timm = (JaxTimmConfig(cache_enabled=False, **video) if jax_side
                else TimmBackboneConfig(**video))
        cfg_cls = JaxConfig if jax_side else RouteformerConfig
        with_video = "with_gaze" in top
        cfg = cfg_cls(gps_backbone_config=gps_cls(**gps, **gps_kw),
                      video_backbone_config=timm if with_video else None, **top)
        kwargs = {}
        if backbone is not None:
            kwargs["gps_backbone"] = backbone
        if with_video:
            kwargs["video_backbone"] = JaxSwin if jax_side else SwinV2Backbone
        if jax_side:
            kwargs["rngs"] = nnx.Rngs(seed + i, dropout=1000 + i)
        model = cls(cfg, **kwargs)
        _zero_dropout(model)
        if jax_side:
            for _, m in nnx.iter_modules(model):
                if isinstance(m, (JaxProbAttention, JaxPerceiveEncoder)):
                    m.factor = EXHAUSTIVE
        else:
            for m in model.modules():
                if isinstance(m, ProbAttention):
                    m.factor = EXHAUSTIVE
        models[name] = model
    return models


@functools.lru_cache(maxsize=None)
def _jax_run(case: str):
    """The JAX trainer's two steps and evaluation, and the weights it
    started from (per trained model). ``case``: the Perceive stacks plain
    (``0``) or fused (``interpret``) in the small Routeformer, or ``zoo``,
    one model of each class the driver's zoo adds."""
    gps, video, top = _configs()
    if case == "zoo":
        models = _zoo_models(jax_side=True)
        config = models["patchtst"].configs
    else:
        model = JaxRouteformer(
            JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                      video_backbone_config=JaxTimmConfig(cache_enabled=False, **video),
                      **top),
            gps_backbone=JaxInformer, video_backbone=JaxSwin, rngs=nnx.Rngs(0, dropout=1))
        for _, m in nnx.iter_modules(model):
            if isinstance(m, (JaxProbAttention, JaxPerceiveEncoder)):
                m.factor = EXHAUSTIVE
        models, config = {"routeformer": model}, model.configs
    rng = np.random.default_rng(0)
    flat = {name: export_params(m, rng) for name, m in models.items()}
    models["stationary_baseline"] = JaxRouteformer(
        JaxConfig(gps_backbone_config=JaxGPSConfig(**gps), discount_factor=SCHEDULE,
                  epsilon=1.0),
        gps_backbone=JaxStationary, rngs=nnx.Rngs(1, dropout=2))
    trainer = JaxTrainer(models, jax_build_optimizer(**OPT), config, unfreeze_epoch=None)
    evaluation = None
    if case != "interpret":  # the eval forward's fused stack is held in test_torch_fusion_stack
        trainer.epoch = EPOCHS[1]
        evaluation = {k: float(v) for k, v in trainer.evaluate(VAL).items()}
    steps, moments = [], None
    for epoch, batch in zip(EPOCHS, TRAIN):
        trainer.epoch = epoch
        steps.append({k: float(v) for k, v in trainer.training_step(batch).items()})
        if moments is None:
            moments = {name: {} for name in flat}
            for group in trainer.opt_state[1].inner_states.values():
                for name in flat:
                    moments[name].update(_flat_torch(group.inner_state[0].mu[name]))
    params = {name: _flat_torch(trainer.params[name]) for name in flat}
    return flat, steps, moments, params, evaluation


@pytest.mark.parametrize("case", ["0", "interpret", "zoo"],
                         ids=["plain-stack", "fused-stack", "zoo"])
def test_trainer_steps_and_eval_match_jax(monkeypatch, case):
    """- metrics of both steps (``train_{metric}_{model}`` and
      ``train_total_loss``): the same keys, 1e-5 relative;
    - the gradients after the first step, read from Adam's first moment:
      1e-5 of the largest;
    - the parameters after the second step by ``test_train_step_matches_jax``'s
      rule (1e-3 lr where the gradient is firm, else 2 lr);
    - the baseline has no parameters and stays out of the optimizer;
    - with the plain stacks, ``evaluate`` over two batches at epoch 12,
      before the steps (after them, AdamW's first updates, lr x the sign of
      gradients that are 0 up to rounding, leave the weights up to 2 lr
      apart): the same key set (per-model loss, ADE, FDE, every PCI bucket
      and the bucket means), 1e-5 relative.

    ``zoo`` trains one model of each class the driver's zoo adds side by
    side (Routeformers over the Transformer, DLinear, NLinear with
    per-channel heads and PatchTST with video, AutoBotAdapted, AdaptedGIMO
    and MultiModalTransformer), every dropout at 0: the port's trainer runs
    one backward per model, the JAX trainer one gradient program per
    model, under one clipped AdamW."""
    fusion = "0" if case == "zoo" else case
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", fusion)
    flat, want_steps, want_g, want_p, want_eval = _jax_run(case)
    if case == "zoo":
        models = _zoo_models(jax_side=False)
        models["stationary_baseline"] = port_models()["stationary_baseline"]
    else:
        models = port_models()
    for name, params in flat.items():
        load_flax_params(models[name], params)
    trainer = ParallelTrainer(models, lambda m: build_optimizer(m, **OPT),
                              next(iter(models.values())).configs, device="cpu",
                              unfreeze_epoch=None)
    assert list(trainer.trained) == list(flat)
    assert not list(models["stationary_baseline"].parameters())
    assert len(trainer.optimizer.params) == sum(
        len(list(models[n].parameters())) for n in flat)

    if want_eval is not None:
        trainer.epoch = EPOCHS[1]
        got_eval = trainer.evaluate(VAL)
        assert set(got_eval) == set(want_eval)
        assert len(want_eval) == (len(flat) + 1) * (3 + 2 * 6 * 3)
        for key, value in want_eval.items():
            assert got_eval[key].item() == pytest.approx(value, rel=1e-5, abs=1e-6), key
        assert all(m.training for m in models.values())  # evaluation restores train mode
    g_scale = {}
    for i, (epoch, batch) in enumerate(zip(EPOCHS, TRAIN)):
        trainer.epoch = epoch
        got = trainer.training_step(batch)
        assert set(got) == set(want_steps[i])
        assert {f"train_loss_{n}" for n in flat} <= set(got)
        for key, value in want_steps[i].items():
            assert got[key].item() == pytest.approx(value, rel=1e-5), (i, key)
        if i == 0:
            for name in flat:
                got_g = {k: trainer.optimizer.opt.state[p]["exp_avg"].numpy()
                         for k, p in models[name].named_parameters()}
                assert set(got_g) == set(want_g[name]), name
                g_scale[name] = max(np.abs(g).max() for g in want_g[name].values())
                for k, g in want_g[name].items():
                    assert np.abs(got_g[k] - g).max() <= 1e-5 * g_scale[name], (name, k)
    if case != "zoo":
        assert want_steps[0]["train_total_loss"] == pytest.approx(
            want_steps[0]["train_loss_routeformer"])
    lr = OPT["learning_rate"]
    for name in flat:
        for k, p in models[name].named_parameters():
            diff = np.abs(p.detach().numpy() - want_p[name][k])
            firm = np.abs(want_g[name][k]) > 1e-3 * g_scale[name]
            assert diff[firm].max(initial=0.0) <= 1e-3 * lr, (name, k)
            assert diff.max() <= 2 * max(lr, OPT["video_backbone_lr"]), (name, k)


def test_mc_eval_is_reproducible_and_samples():
    """Real ProbSparse factors: two evaluations give the same bits, and the
    five MC forwards of one batch differ from each other."""
    torch.manual_seed(0)
    models = port_models(factor=5)
    trainer = port_trainer(models)
    first = trainer.evaluate(VAL)
    second = trainer.evaluate(VAL)
    assert set(first) == set(second)
    for key in first:
        assert torch.equal(first[key], second[key]), key

    model = models["routeformer"].eval()
    batch = {k: torch.from_numpy(v) for k, v in VAL[0]["train"].items()}
    set_mc_sampling(model, trainer.eval_generator)
    trainer.eval_generator.manual_seed(EVAL_SEED)
    with torch.no_grad():
        a, b = model(batch)[0], model(batch)[0]
    set_mc_sampling(model, None)
    assert not torch.equal(a, b)
    with torch.no_grad():  # without the generator, eval is the fixed sample
        assert torch.equal(model(batch)[0], model(batch)[0])


def test_unfreeze_boundary():
    """No backbone gradient up to ``unfreeze_epoch``, a finite non-zero
    one after it."""
    trainer = port_trainer(port_models(), unfreeze_epoch=10)
    backbone = trainer.models["routeformer"].video_backbone
    trainer.epoch = 10
    trainer.training_step(TRAIN[0])
    assert not backbone.unfreeze
    # the optimizer gives a frozen parameter a zero gradient, as optax does
    assert all(p.grad is None or not p.grad.any() for p in backbone.parameters())
    trainer.epoch = 11
    trainer.training_step(TRAIN[0])
    assert backbone.unfreeze
    grads = [p.grad for p in backbone.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert max(g.abs().max().item() for g in grads) > 0.0


def test_refusals():
    with pytest.raises(ValueError, match="unfreeze"):
        port_trainer(port_models(), unfreeze_epoch=10, feature_cache_active=True)
    with pytest.raises(TypeError, match="DeviceMesh of make_mesh"):
        port_trainer(port_models(), mesh=object())
    port_trainer(port_models(), unfreeze_epoch=None, feature_cache_active=True)


def test_fit_advances_the_epoch():
    trainer = port_trainer(port_models())
    seen = []
    history = trainer.fit(TRAIN[:1], VAL[:1], epochs=2,
                          on_metrics=lambda split, epoch, i, m: seen.append((split, epoch)))
    assert trainer.epoch == 2 and len(history) == 2
    assert seen == [("train", 0), ("val", 0), ("train", 1), ("val", 1)]
    trainer.fit(TRAIN[:1], epochs=1)
    assert trainer.epoch == 3


def test_maybe_split_video_does_not_mutate():
    video = np.arange(2 * 3 * 4 * 6 * 3, dtype=np.float32).reshape(2, 3, 4, 6, 3)
    batch = {"train": {"left_video": video, "gps": np.zeros((2, 3, 2))},
             "target": {"left_video": video}}
    out = maybe_split_video(batch)
    assert batch["train"]["left_video"] is video and "right_video" not in batch["train"]
    np.testing.assert_array_equal(out["train"]["left_video"], video[:, :, :, :3])
    np.testing.assert_array_equal(out["train"]["right_video"], video[:, :, :, 3:])
    again = maybe_split_video(out)
    assert again["train"]["left_video"] is out["train"]["left_video"]
    assert maybe_split_video(batch, enabled=False) is batch
