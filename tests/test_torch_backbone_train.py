"""Backbone training against the JAX package on the CPU.

- The photometric augment: each op at the same factors, and the batched
  apply step fed JAX's own per-frame draws (derived from each frame's key
  as ``_augment_one`` derives them) against ``photometric_augment``; the
  port's draws in range and reproducible from a generator. f32 at 1e-5.
- ``train_backbone=True`` on a small SwinV2 (tanh, the fused block's plain
  version, and exact, window attention's) and a ViT at 576 tokens (K4's
  route): the gradient of a loss on the training-mode features against
  JAX's (1e-4 of the largest gradient), with ``photometric_augment``
  patched to the identity on both sides in the test; remat on and off give
  the same gradients (1e-6 of the largest).
- A Routeformer train step with ``train_backbone=True``: the backbone's
  parameters are the optimizer's ``video_backbone`` group, receive a
  non-zero gradient and move; the augment runs only when the backbone
  trains and the model is in training mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_tpu.models.video_backbone import vit as jax_vit
from routeformer_tpu.ops import augment as jax_augment
from routeformer_torch.convert import flax_to_torch_names, load_flax_params
from routeformer_torch.flagship import init_weights
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.video_backbone import (
    SwinV2Backbone,
    TimmBackbone,
    TimmBackboneConfig,
    vit,
)
from routeformer_torch.ops import augment
from routeformer_torch.optimizers import build_optimizer
from test_torch_models import export_params
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

LONG = "vit_long_test"
AUG_TOL = dict(atol=1e-5, rtol=1e-5)


def _images(seed, n=4, h=12, w=16):
    return np.random.RandomState(seed).uniform(size=(n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("op,factor", [
    ("adjust_brightness", 1.17), ("adjust_contrast", 0.83), ("adjust_saturation", 1.2),
    ("adjust_hue", 0.07), ("adjust_hue", -0.09), ("adjust_sharpness", 2.0),
    ("autocontrast", None), ("rgb_to_hsv", None)])
def test_augment_ops_match_jax(op, factor):
    x = _images(1)
    args = () if factor is None else (factor,)
    batched = op in ("adjust_sharpness",)
    want = (np.asarray(jax.vmap(lambda i: getattr(jax_augment, op)(i, *args))(jnp.asarray(x)))
            if batched or op in ("autocontrast", "adjust_contrast")
            else np.asarray(getattr(jax_augment, op)(jnp.asarray(x), *args)))
    got = getattr(augment, op)(torch.from_numpy(x), *args).numpy()
    np.testing.assert_allclose(got, want, **AUG_TOL)
    if op == "rgb_to_hsv":
        np.testing.assert_allclose(augment.hsv_to_rgb(torch.from_numpy(got)).numpy(), x,
                                   **AUG_TOL)


def jax_draws(keys, h, w) -> dict:
    """Each frame's draws as ``_augment_one`` derives them from its key
    (the pipeline's default settings)."""
    out = {k: [] for k in ("sharp", "auto", "brightness", "contrast", "saturation", "hue",
                           "order", "erase_top", "erase_left", "erase_h", "erase_w")}
    for key in keys:
        k1, k2, k3, k4, _, _ = jax.random.split(key, 6)
        out["sharp"].append(bool(jax.random.bernoulli(k1, 0.5)))
        out["auto"].append(bool(jax.random.bernoulli(k2, 0.5)))
        k_perm, k_b, k_c, k_s, k_h = jax.random.split(k3, 5)
        for name, k in (("brightness", k_b), ("contrast", k_c), ("saturation", k_s)):
            out[name].append(float(jax.random.uniform(k, minval=0.8, maxval=1.2)))
        out["hue"].append(float(jax.random.uniform(k_h, minval=-0.1, maxval=0.1)))
        out["order"].append(np.asarray(jax.random.permutation(k_perm, 4)))
        k_area, k_aspect, k_i, k_j = jax.random.split(k4, 4)
        area = h * w * jax.random.uniform(k_area, minval=0.02, maxval=0.2)
        aspect = jnp.exp(jax.random.uniform(k_aspect, minval=jnp.log(0.3),
                                            maxval=jnp.log(3.3)))
        eh = int(jnp.clip(jnp.round(jnp.sqrt(area * aspect)), 1, h))
        ew = int(jnp.clip(jnp.round(jnp.sqrt(area / aspect)), 1, w))
        out["erase_h"].append(eh)
        out["erase_w"].append(ew)
        out["erase_top"].append(min(int(jax.random.randint(k_i, (), 0, h)), h - eh))
        out["erase_left"].append(min(int(jax.random.randint(k_j, (), 0, w)), w - ew))
    return {k: torch.tensor(np.asarray(v)) for k, v in out.items()}


def test_apply_step_matches_jax_pipeline_with_its_draws():
    n, h, w = 16, 12, 16
    x = _images(2, n, h, w)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_augment.photometric_augment(jnp.asarray(x), key))
    draws = jax_draws(jax.random.split(key, n), h, w)
    assert draws["sharp"].any() and not draws["sharp"].all()
    got = augment.apply_augment(torch.from_numpy(x), draws).numpy()
    np.testing.assert_allclose(got, want, **AUG_TOL)


def test_draws_are_in_range_and_reproducible():
    n, h, w = 64, 20, 30
    draws = augment.draw_augment(n, h, w, torch.Generator().manual_seed(4))
    again = augment.draw_augment(n, h, w, torch.Generator().manual_seed(4))
    assert all(torch.equal(draws[k], again[k]) for k in draws)
    assert ((draws["brightness"] >= 0.8) & (draws["brightness"] <= 1.2)).all()
    assert (draws["hue"].abs() <= 0.1).all()
    assert (torch.sort(draws["order"], dim=1).values == torch.arange(4)).all()
    assert ((draws["erase_top"] >= 0) & (draws["erase_top"] + draws["erase_h"] <= h)).all()
    assert ((draws["erase_left"] >= 0) & (draws["erase_left"] + draws["erase_w"] <= w)).all()
    x = torch.from_numpy(_images(5, n, h, w)).half()
    out = augment.photometric_augment(x, torch.Generator().manual_seed(4))
    assert out.dtype == torch.float16 and out.shape == x.shape
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


@pytest.fixture
def no_augment(monkeypatch):
    """The augment patched to the identity on both sides (its draws cannot
    be shared through a backbone); counts the port's calls."""
    calls = []
    monkeypatch.setattr(jax_augment, "photometric_augment", lambda images, key, **kw: images)
    monkeypatch.setattr(augment, "photometric_augment",
                        lambda images, generator=None, **kw: calls.append(images.shape)
                        or images)
    monkeypatch.setitem(jax_vit.PRESETS, LONG, jax_vit.ViTPreset(96, 4, 32, 2, 4))
    monkeypatch.setitem(vit.PRESETS, LONG, vit.ViTPreset(96, 4, 32, 2, 4))
    monkeypatch.setenv("ROUTEFORMER_SWIN_BLOCK_FUSION", "0")  # JAX: the block's einsum math
    return calls


def _backbone_pair(rng, kind, remat):
    if kind == "vit":
        kw = dict(model_type=LONG, compute_dtype="float32")
        jax_cls, port_cls = jax_vit.TimmBackbone, TimmBackbone
    else:
        kw = dict(model_type="swinv2_parity_test", compute_dtype="float32", gelu=kind)
        jax_cls, port_cls = JaxSwin, SwinV2Backbone
    jax_model = jax_cls(JaxTimmConfig(cache_enabled=False, train_backbone=True, remat=remat,
                                      **kw), rngs=nnx.Rngs(0, dropout=1))
    port = port_cls(TimmBackboneConfig(train_backbone=True, remat=remat, **kw))
    load_flax_params(port, export_params(jax_model, rng))
    return jax_model, port


def _port_grads(port, x):
    port.zero_grad()
    (port(torch.from_numpy(x)) ** 2).mean().backward()
    return {n: p.grad.clone() for n, p in port.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("kind", ["tanh", "exact", "vit"])
def test_backbone_training_gradient_matches_jax(rng, no_augment, kind):
    jax_model, port = _backbone_pair(rng, kind, remat=False)
    jax_model.train()
    port.train()
    x = _images(6, 2, 64, 64) if kind != "vit" else _images(6, 2, 54, 96)
    grads = nnx.jit(nnx.grad(lambda m: (m(jnp.asarray(x)) ** 2).mean()))(jax_model)
    want = flax_to_torch_names({".".join(map(str, k)): np.asarray(v[...]) for k, v in
                                nnx.to_flat_state(grads)})
    got = _port_grads(port, x)
    assert len(no_augment) == 1  # the gate: train_backbone and training mode
    scale = max(np.abs(g).max() for g in want.values())
    assert set(got) == set(want) and scale > 0
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, rtol=0, atol=1e-4 * scale,
                                   err_msg=name)
    port.eval()
    with torch.no_grad():
        port(torch.from_numpy(x))
    assert len(no_augment) == 1  # no augment in eval


@pytest.mark.parametrize("kind", ["tanh", "vit"])
def test_remat_gives_the_same_gradients(rng, no_augment, kind):
    """Remat on and off: the same loss and gradients (the blocks' forward,
    kernels included, runs again in the backward)."""
    _, port = _backbone_pair(rng, kind, remat=False)
    _, remat = _backbone_pair(rng, kind, remat=True)
    remat.load_state_dict(port.state_dict())
    port.train()
    remat.train()
    x = _images(7, 2, 64, 64) if kind != "vit" else _images(7, 2, 54, 96)
    want, got = _port_grads(port, x), _port_grads(remat, x)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=0, atol=1e-6 * scale,
                                   err_msg=name)


def test_routeformer_step_trains_the_backbone(monkeypatch):
    """One train step of a small Routeformer with ``train_backbone``: the
    backbone's parameters are the optimizer's second group, get a finite,
    non-zero gradient and move; the augment ran on the step's frames."""
    calls = []
    real = augment.photometric_augment
    monkeypatch.setattr(augment, "photometric_augment",
                        lambda images, generator=None: calls.append(images.shape)
                        or real(images, generator))
    from routeformer_torch.parallel import make_train_step
    from routeformer_torch.train import TrainingLosses, routeformer_training_loss
    from test_torch_routeformer import _kwargs

    gps, video, top = _kwargs(4)
    cfg = RouteformerConfig(gps_backbone_config=GPSBackboneConfig(**gps),
                            video_backbone_config=TimmBackboneConfig(
                                **dict(video, gelu="tanh"), train_backbone=True, remat=True),
                            discount_factor={0: 0.97}, epsilon=1.0, visual_epsilon=0.3,
                            dense_loss_ratio=0.5, **top)
    model = Routeformer(cfg)
    init_weights(model, 2)
    model.train()
    opt = build_optimizer(model, learning_rate=1e-3, video_backbone_lr=1e-3,
                          warmup_epochs=0, max_epochs=10)
    backbone = {id(p) for p in model.video_backbone.parameters()}
    assert {id(p) for p in opt.opt.param_groups[1]["params"]} == backbone
    losses = TrainingLosses.from_config(model.configs)
    step = make_train_step(model, opt, lambda m, i, t, e: routeformer_training_loss(
        m, i, t, e, losses))
    from routeformer_torch.io.synthetic import synthetic_batch_numpy

    data = synthetic_batch_numpy(3, 2, seq_len=8, pred_len=6, with_video=True,
                                 with_gaze=True, frame_hw=(64, 64), gaze_len=40)
    batch, target = ({k: torch.from_numpy(v) for k, v in data[part].items()}
                     for part in ("train", "target"))
    before = {n: p.detach().clone() for n, p in model.video_backbone.named_parameters()}
    metrics = step(batch, target, 12)
    assert math.isfinite(float(metrics["loss"]))
    grads = [p.grad for p in model.video_backbone.parameters()]
    assert all(g is not None for g in grads)
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads])))
    assert math.isfinite(norm) and norm > 0
    moved = [n for n, p in model.video_backbone.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert len(moved) == len(before)
    assert calls and all(s[-1] == 3 for s in calls)
