"""The port's training pieces against the JAX package on the CPU: the
future-discounted loss, ADE/FDE, the learning-rate schedule, the grouped
AdamW with clipping against optax, and the whole train step (forward,
loss, backward, clip, AdamW) against JAX ``make_train_step`` without a mesh
on the small SwinV2 config of ``test_torch_routeformer.py``, with the
Perceive stacks plain and fused. Inputs are made from numpy seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn
from flax import nnx

from routeformer_tpu.losses import FutureDiscountedLoss as JaxLoss
from routeformer_tpu.models import RouteformerConfig as JaxConfig
from routeformer_tpu.models.cross_modal import PerceiveEncoder as JaxPerceiveEncoder
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone import Informer as JaxInformer
from routeformer_tpu.models.layers.attention import ProbAttention as JaxProbAttention
from routeformer_tpu.models.routeformer import Routeformer as JaxRouteformer
from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_tpu.optimizers import build_optimizer as jax_build_optimizer
from routeformer_tpu.optimizers import linear_warmup_cosine_annealing as jax_schedule
from routeformer_tpu.parallel import make_train_step as jax_make_train_step
from routeformer_tpu.parallel.train_step import make_eval_step as jax_make_eval_step
from routeformer_tpu.score.error import ade as jax_ade
from routeformer_tpu.score.error import fde as jax_fde_one
from routeformer_tpu.score.error import fde_per_sample as jax_fde
from routeformer_tpu.train import TrainingLosses as JaxTrainingLosses
from routeformer_tpu.train import routeformer_training_loss as jax_training_loss
from routeformer_torch.convert import flax_to_torch_names, load_flax_params
from routeformer_torch.losses import FutureDiscountedLoss
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.layers import ProbAttention
from routeformer_torch.models.video_backbone import TimmBackboneConfig
from routeformer_torch.optimizers import build_optimizer, linear_warmup_cosine_annealing
from routeformer_torch.parallel import make_eval_step, make_train_step
from routeformer_torch.score import ade, fde, fde_per_sample
from routeformer_torch.train import TrainingLosses, routeformer_training_loss
from test_torch_models import export_params
from test_torch_routeformer import EXHAUSTIVE, PRED_LEN, _inputs, _kwargs

SCHEDULE = {0: 0.97, 10: 0.98}


# ------------------------------------------------------------- losses --- #


@pytest.mark.parametrize("loss_function", ["mae", "mse", "smooth_l1"])
@pytest.mark.parametrize("epsilon", [None, 0.3])
@pytest.mark.parametrize("discount", [0.9, SCHEDULE])
def test_future_discounted_loss_matches_jax(rng, loss_function, epsilon, discount):
    """Every loss, with and without the epsilon zone (smooth-l1 ignores
    it), at epochs on both sides of the schedule's step: f32, 1e-6."""
    pred = rng.normal(size=(3, 7, 5)).astype(np.float32)
    true = (pred + rng.normal(size=pred.shape) * 0.5).astype(np.float32)
    port = FutureDiscountedLoss(discount, epsilon, loss_function)
    ref = JaxLoss(discount, epsilon, loss_function)
    for epoch in (0, 9, 10, 150):
        got = port(torch.from_numpy(pred), torch.from_numpy(true), epoch).item()
        want = float(ref(jnp.asarray(pred), jnp.asarray(true), epoch))
        assert got == pytest.approx(want, rel=1e-6), epoch


def test_smooth_l1_ignores_epsilon_and_schedule_needs_epoch_0(rng):
    pred = rng.normal(size=(2, 4, 2)).astype(np.float32)
    true = (pred + 0.1).astype(np.float32)  # every error inside the zone
    args = (torch.from_numpy(pred), torch.from_numpy(true))
    assert FutureDiscountedLoss(0.9, 0.3, "mse")(*args).item() == 0.0
    assert FutureDiscountedLoss(0.9, 0.3, "smooth_l1")(*args).item() > 0.0
    with pytest.raises(ValueError):
        FutureDiscountedLoss({5: 0.9})
    with pytest.raises(ValueError):
        FutureDiscountedLoss(0.9, loss_function="huber")


def test_ade_fde_match_jax(rng):
    pred = rng.normal(size=(4, 6, 2)).astype(np.float32)
    true = rng.normal(size=(4, 6, 2)).astype(np.float32)
    got_ade = ade(torch.from_numpy(pred), torch.from_numpy(true)).item()
    assert got_ade == pytest.approx(float(jax_ade(jnp.asarray(pred), jnp.asarray(true))),
                                    rel=1e-6)
    np.testing.assert_allclose(fde_per_sample(torch.from_numpy(pred), torch.from_numpy(true)),
                               np.asarray(jax_fde(jnp.asarray(pred), jnp.asarray(true))),
                               rtol=1e-6)


@pytest.mark.parametrize("shape", [(6, 2), (4, 6, 2)], ids=["one", "batched"])
def test_fde_keeps_the_per_sample_contract(rng, shape):
    """``fde`` indexes ``[-1]`` on dim 0 as the reference does: the final
    point of one ``(T, 2)`` trajectory, and on a batch the distance of the
    last sample's trajectories (the quirk the JAX package keeps). 1e-6."""
    pred = rng.normal(size=shape).astype(np.float32)
    true = rng.normal(size=shape).astype(np.float32)
    got = fde(torch.from_numpy(pred), torch.from_numpy(true))
    assert got.ndim == 0
    assert got.item() == pytest.approx(float(jax_fde_one(jnp.asarray(pred), jnp.asarray(true))),
                                       rel=1e-6)


def test_eval_step_matches_jax(rng):
    """``make_eval_step``: an eval-mode forward under ``inference_mode``
    (the model put in eval mode, ProbSparse on the eval key sample) against
    JAX ``make_eval_step`` at the same weights, f32 at 1e-5; ``mesh=``
    takes a ``make_mesh`` DeviceMesh only."""
    gps, _, _ = _kwargs(4)
    top = dict(discount_factor={0: 0.97}, epsilon=1.0)
    jax_model = JaxRouteformer(JaxConfig(gps_backbone_config=JaxGPSConfig(**gps), **top),
                               gps_backbone=JaxInformer, rngs=nnx.Rngs(0, dropout=1))
    port = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps), **top))
    load_flax_params(port, export_params(jax_model, rng))
    port.train()

    def eval_fn(m, batch):
        return m(batch)

    jax_step, params, state = jax_make_eval_step(jax_model, eval_fn)
    step = make_eval_step(port, eval_fn)
    assert not port.training
    gps_in = _inputs(3)["gps"]
    got = step({"gps": torch.from_numpy(gps_in)})
    want = np.asarray(jax_step(params, state, {"gps": jnp.asarray(gps_in)}))
    assert got.is_inference() and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(TypeError, match="DeviceMesh of make_mesh"):
        make_eval_step(port, eval_fn, mesh=object())


# ----------------------------------------------------------- schedule --- #


@pytest.mark.parametrize("warmup,max_epochs,steps_per_epoch", [(2, 200, 1), (5, 20, 3),
                                                               (1, 10, 4)])
def test_schedule_matches_jax(warmup, max_epochs, steps_per_epoch):
    """Warmup (``warmup - 1`` denominator, from 0) then cosine, with the
    epoch the floor of ``step / steps_per_epoch``; f32 as in optax."""
    kw = dict(warmup_epochs=warmup, max_epochs=max_epochs, steps_per_epoch=steps_per_epoch)
    port = linear_warmup_cosine_annealing(1e-3, **kw)
    ref = jax_schedule(1e-3, **kw)
    assert port(0) == 0.0
    for step in range(0, (max_epochs + 2) * steps_per_epoch):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12), step


# ---------------------------------------------------------- optimizer --- #


class _Pair(nn.Module):
    def __init__(self):
        super().__init__()
        self.video_backbone = nn.Linear(4, 3)
        self.head = nn.Linear(3, 2)


def _optax_params(model):
    """The port module's parameters as the JAX layout's nested dict."""
    return {name: {"w": np.asarray(m.weight.detach().numpy()),
                   "b": np.asarray(m.bias.detach().numpy())}
            for name, m in (("video_backbone", model.video_backbone), ("head", model.head))}


@pytest.mark.parametrize("frozen_backbone", [False, True])
def test_optimizer_matches_optax(rng, frozen_backbone):
    """Three updates from a fresh state on identical gradients (the first
    at rate 0: warmup starts there), the global norm clipped (it is far
    above 0.5), the backbone on its own rate; with ``frozen_backbone`` its
    parameters have no gradient in the port and zero gradients in optax,
    and decay all the same. The returned pre-clip norm at 1e-6 relative;
    the parameters after each update at 1e-6 absolute (optax and torch
    apply the bias corrections and the decay in another order: f32
    rounding, 2e-5 of a step at the larger rate)."""
    torch.manual_seed(0)
    model = _Pair()
    kw = dict(learning_rate=1e-2, weight_decay=0.1, video_backbone_lr=5e-2,
              warmup_epochs=2, max_epochs=10, steps_per_epoch=1, gradient_clip_val=0.5)
    port = build_optimizer(model, **kw)
    tx = jax_build_optimizer(**kw)
    params = jax.tree.map(jnp.asarray, _optax_params(model))
    state = tx.init(params)
    for _ in range(3):
        grads = {"video_backbone": {"w": rng.normal(size=(3, 4)), "b": rng.normal(size=3)},
                 "head": {"w": rng.normal(size=(2, 3)), "b": rng.normal(size=2)}}
        grads = jax.tree.map(lambda a: (a * 3).astype(np.float32), grads)
        if frozen_backbone:
            grads["video_backbone"] = jax.tree.map(np.zeros_like, grads["video_backbone"])
        port.zero_grad()
        for name in ("video_backbone", "head"):
            if frozen_backbone and name == "video_backbone":
                continue
            m = getattr(model, name)
            m.weight.grad = torch.tensor(grads[name]["w"])  # copies: clipping is in place
            m.bias.grad = torch.tensor(grads[name]["b"])
        norm = port.step().item()
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, params)
        params = optax.apply_updates(params, updates)
        assert norm == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        for name, leaves in _optax_params(model).items():
            for key, value in leaves.items():
                np.testing.assert_allclose(value, np.asarray(params[name][key]),
                                           rtol=0, atol=1e-6)
    if frozen_backbone:  # decoupled decay moved the weights without a gradient
        assert not np.allclose(_optax_params(model)["video_backbone"]["w"],
                               _optax_params(_Pair())["video_backbone"]["w"])


# ---------------------------------------------------------- train step --- #

OPT = dict(learning_rate=1e-3, weight_decay=0.1, video_backbone_lr=1e-2, warmup_epochs=2,
           max_epochs=20, steps_per_epoch=1, gradient_clip_val=0.5)


@functools.lru_cache(maxsize=None)
def _jax_setup(fusion: str):
    """The JAX model, its jitted step (traced once per fusion mode: the
    epoch is a traced argument) and the initial parameters, exported."""
    gps, video, top = _kwargs(EXHAUSTIVE)
    top = dict(top, discount_factor=SCHEDULE, epsilon=1.0, visual_epsilon=0.3)
    model = JaxRouteformer(
        JaxConfig(gps_backbone_config=JaxGPSConfig(**gps),
                  video_backbone_config=JaxTimmConfig(cache_enabled=False, **video), **top),
        gps_backbone=JaxInformer, video_backbone=JaxSwin, rngs=nnx.Rngs(0, dropout=1))
    for _, m in nnx.iter_modules(model):
        if isinstance(m, (JaxProbAttention, JaxPerceiveEncoder)):
            m.factor = EXHAUSTIVE
    flat = export_params(model, np.random.default_rng(0))
    losses = JaxTrainingLosses.from_config(model.configs)
    step, params, state, opt_state = jax_make_train_step(
        model, jax_build_optimizer(**OPT),
        lambda m, i, t, e: jax_training_loss(m, i, t, e, losses))
    assert model.frame_encoder._fused_kernel_mode() == ("interpret" if fusion == "1" else None)
    return step, (params, state, opt_state), flat, (gps, video, top)


def _flat_torch(state) -> dict:
    """An nnx State (params, or Adam's first moment) by port parameter
    name; leaves of the other optax group are skipped."""
    flat = {}
    for path, var in nnx.to_flat_state(state):
        value = var.get_value() if hasattr(var, "get_value") else var
        if not isinstance(value, optax.MaskedNode):
            flat[".".join(str(p) for p in path)] = np.asarray(value)
    return flax_to_torch_names(flat)


def _first_moments(opt_state) -> dict:
    moments = {}
    for group in opt_state[1].inner_states.values():
        moments.update(_flat_torch(group.inner_state[0].mu))
    return moments


@pytest.mark.parametrize("epoch", [3, 12])
@pytest.mark.parametrize("fusion", ["0", "1"], ids=["plain-stack", "fused-stack"])
def test_train_step_matches_jax(monkeypatch, fusion, epoch):
    """Two steps from a fresh optimizer (the first at rate 0), dropout 0,
    no motion noise, exhaustive ProbSparse; epoch 3 (dense loss weighted 0)
    and 12 (dense loss on, the schedule's second discount). The fused
    stack runs its plain versions here and the JAX package its Pallas
    kernels in interpret mode.

    - metrics of both steps: 1e-5 relative (f32; sums in another order);
    - the gradients, read from Adam's first moment after the first step
      (0.1 x the clipped gradient in both): 1e-5 of the largest;
    - the parameters after the second step: AdamW's first real update is
      about lr x sign(g), so where the gradient is well above the gradient
      tolerance (1e-3 of the largest) the updates agree to 1e-3 lr, and
      elsewhere (gradients that are 0 up to rounding) within 2 lr.
    """
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "interpret" if fusion == "1" else "0")
    jax_step, initial, flat, (gps, video, top) = _jax_setup(fusion)
    port = Routeformer(RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                                         video_backbone_config=TimmBackboneConfig(**video),
                                         **top))
    for m in port.modules():
        if isinstance(m, ProbAttention):
            m.factor = EXHAUSTIVE
    load_flax_params(port, flat)
    # "interpret" is read at trace time by JAX and at each call by the port,
    # where it means what "1" means: kernel forward and kernel backward.
    assert port.frame_encoder.fused_kernel_mode() == ("kernel" if fusion == "1" else None)
    optimizer = build_optimizer(port, **OPT)
    losses = TrainingLosses.from_config(port.configs)
    step = make_train_step(port, optimizer,
                           lambda m, i, t, e: routeformer_training_loss(m, i, t, e, losses))

    inp = _inputs(7)
    tgt = {k: v if k == "gaze" else v[:, :PRED_LEN] for k, v in _inputs(8).items()}
    j_inp, j_tgt = ({k: jnp.asarray(v) for k, v in b.items()} for b in (inp, tgt))
    t_inp, t_tgt = ({k: torch.from_numpy(v) for k, v in b.items()} for b in (inp, tgt))
    # a fresh copy each time: the jitted step donates its state
    params, state, opt_state = jax.tree.map(lambda a: a.copy(), initial)
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    for i in range(2):
        params, state, opt_state, j_metrics = jax_step(params, state, opt_state, j_inp, j_tgt,
                                                       jnp.asarray(epoch))
        metrics = step(t_inp, t_tgt, epoch)
        assert set(metrics) == set(j_metrics) == {"total_loss", "grad_norm", "loss",
                                                  "dense_loss", "ade", "fde"}
        for key, value in j_metrics.items():
            assert metrics[key].item() == pytest.approx(float(value), rel=1e-5), (i, key)
        if i == 0:
            want_g = _first_moments(opt_state)
            got_g = {k: optimizer.opt.state[p]["exp_avg"].numpy()
                     for k, p in port.named_parameters()}
            assert set(got_g) == set(want_g)
            g_scale = max(np.abs(g).max() for g in want_g.values())
            for k, g in want_g.items():
                assert np.abs(got_g[k] - g).max() <= 1e-5 * g_scale, k
    if epoch < 10:
        assert float(j_metrics["total_loss"]) == pytest.approx(float(j_metrics["loss"]))

    lr = OPT["learning_rate"]
    want_p = _flat_torch(params)
    moved = {"video_backbone": 0.0, "rest": 0.0}
    for k, p in port.named_parameters():
        got = p.detach().numpy()
        group = "video_backbone" if k.startswith("video_backbone") else "rest"
        moved[group] = max(moved[group], np.abs(got - before[k].numpy()).max())
        diff = np.abs(got - want_p[k])
        firm = np.abs(want_g[k]) > 1e-3 * g_scale
        assert diff[firm].max(initial=0.0) <= 1e-3 * lr, k
        assert diff.max() <= 2 * max(lr, OPT["video_backbone_lr"]), k
    assert moved["rest"] > 0.0 and moved["video_backbone"] > 0.0  # the frozen weights decay
