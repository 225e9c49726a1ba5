"""The GPS backbones of the driver's zoo against the JAX package on the
CPU: the vanilla Transformer, DLinear and NLinear (``individual`` both
ways) and PatchTST (train and eval mode, its BatchNorm running statistics
over two SGD steps), with every parameter carried by ``load_flax_params``.
f32 at atol/rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models.gps_backbone import DLinear as JaxDLinear
from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone import LinearBackboneConfig as JaxLinearConfig
from routeformer_tpu.models.gps_backbone import NLinear as JaxNLinear
from routeformer_tpu.models.gps_backbone import PatchTST as JaxPatchTST
from routeformer_tpu.models.gps_backbone import PatchTSTBackboneConfig as JaxPatchConfig
from routeformer_tpu.models.gps_backbone import Transformer as JaxTransformer
from routeformer_tpu.models.gps_backbone.linear import moving_average as jax_moving_average
from routeformer_torch.convert import load_flax_params
from routeformer_torch.models.gps_backbone import (
    DLinear,
    GPSBackboneConfig,
    LinearBackboneConfig,
    NLinear,
    PatchTST,
    PatchTSTBackboneConfig,
    Transformer,
)
from routeformer_torch.models.gps_backbone.linear import moving_average
from test_torch_models import export_params
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

B, SEQ_LEN, PRED_LEN, ENC_IN = 3, 40, 30, 7
TOL = dict(atol=1e-4, rtol=1e-4)


def _gps(**kw):
    return dict(dict(seq_len=SEQ_LEN, label_len=SEQ_LEN, pred_len=PRED_LEN, d_model=32,
                     n_heads=4, e_layers=2, d_layers=1, d_ff=64, dropout=0.0,
                     activation="relu", _enc_in=ENC_IN, _c_out=3), **kw)


def _pair(jax_cls, jax_cfg_cls, port_cls, port_cfg_cls, rng, **kw):
    jax_model = jax_cls(jax_cfg_cls(**_gps(**kw)), rngs=nnx.Rngs(0, dropout=1))
    port = port_cls(port_cfg_cls(**_gps(**kw)))
    n = load_flax_params(port, export_params(jax_model, rng))
    assert n == sum(1 for k in port.state_dict() if "num_batches_tracked" not in k)
    return jax_model, port


def _x(seed, b=B):
    return np.random.RandomState(seed).randn(b, SEQ_LEN, ENC_IN).astype(np.float32)


def _forward(jax_model, port, x, train):
    if train:
        jax_model.train()
        port.train()
    else:
        jax_model.eval()
        port.eval()
    want = np.asarray(jax_model(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("kernel", [25, 5])
def test_moving_average_matches_jax(kernel):
    x = _x(1)
    got = moving_average(torch.from_numpy(x), kernel).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_moving_average(jnp.asarray(x), kernel)),
                               **TOL)


def test_transformer_matches_jax(rng):
    jax_model, port = _pair(JaxTransformer, JaxGPSConfig, Transformer, GPSBackboneConfig, rng)
    got, want = _forward(jax_model, port, _x(2), train=False)
    assert got.shape == (B, PRED_LEN, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_transformer_output_attention_matches_jax(rng):
    """``output_attention``: the vanilla Transformer returns its encoder
    layers' dense attention maps ``(B, H, L, L)``, the softmax weights
    before dropout, as JAX's. f32 at 1e-4."""
    jcfg, cfg = JaxGPSConfig(**_gps()), GPSBackboneConfig(**_gps())
    jcfg.output_attention = cfg.output_attention = True
    jax_model = JaxTransformer(jcfg, rngs=nnx.Rngs(0, dropout=1))
    port = Transformer(cfg)
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.eval()
    port.eval()
    x = _x(4)
    want, want_attn = jax_model(jnp.asarray(x))
    with torch.no_grad():
        got, attn = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(attn) == len(want_attn) == 2
    for a, w in zip(attn, want_attn):
        assert tuple(a.shape) == w.shape == (B, 4, SEQ_LEN, SEQ_LEN)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("individual", [False, True], ids=["shared", "individual"])
@pytest.mark.parametrize("name", ["dlinear", "nlinear"])
def test_linear_backbones_match_jax(rng, name, individual):
    jax_cls, port_cls = {"dlinear": (JaxDLinear, DLinear), "nlinear": (JaxNLinear, NLinear)}[name]
    jax_model, port = _pair(jax_cls, JaxLinearConfig, port_cls, LinearBackboneConfig, rng,
                            individual=individual, kernel_size=25)
    if individual:
        assert any(k.endswith(".weight") and v.ndim == 3 for k, v in port.state_dict().items())
    got, want = _forward(jax_model, port, _x(3), train=False)
    assert got.shape == (B, PRED_LEN, 3)
    np.testing.assert_allclose(got, want, **TOL)


def _patchtst(rng, **kw):
    kw = dict(dict(patch_len_ratio=0.25, stride_ratio=0.125, padding_patch="end", revin=True,
                   affine=False, subtract_last=False, decomposition=False, kernel_size=25),
              **kw)
    return _pair(JaxPatchTST, JaxPatchConfig, PatchTST, PatchTSTBackboneConfig, rng, **kw)


@pytest.mark.parametrize("variant", [
    {}, {"individual": True, "affine": True}, {"decomposition": True, "subtract_last": True},
], ids=["default", "individual-affine", "decomposition"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_patchtst_matches_jax(rng, variant, train):
    jax_model, port = _patchtst(rng, **variant)
    assert "model_res.W_pos" in port.state_dict() or "model.W_pos" in port.state_dict()
    got, want = _forward(jax_model, port, _x(4), train=train)
    assert got.shape == (B, PRED_LEN, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_patchtst_batchnorm_statistics_over_two_steps(rng):
    """Two SGD steps in train mode on different batches (MSE to a fixed
    target): the running mean and the biased running variance (flax keeps
    the biased batch variance, momentum 0.9) match JAX's after each step, as
    do the losses, and the eval forward on the moved statistics."""
    jax_model, port = _patchtst(rng)
    jax_model.train()
    port.train()
    lr = 1e-2
    target = np.random.RandomState(9).randn(B, PRED_LEN, 3).astype(np.float32)
    start = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}

    def jax_loss(m, x):
        return jnp.mean((m(x) - jnp.asarray(target)) ** 2)

    for step, seed in enumerate((5, 6)):
        x = _x(seed)
        j_loss, grads = nnx.value_and_grad(jax_loss)(jax_model, jnp.asarray(x))
        params = nnx.state(jax_model, nnx.Param)
        nnx.update(jax_model, jax.tree.map(lambda p, g: p - lr * g, params, grads))
        port.zero_grad()
        loss = torch.mean((port(torch.from_numpy(x)) - torch.from_numpy(target)) ** 2)
        loss.backward()
        with torch.no_grad():
            for p in port.parameters():
                p -= lr * p.grad
        assert loss.item() == pytest.approx(float(j_loss), rel=1e-5), step
        stats = {".".join(str(p) for p in path): np.asarray(v[...])
                 for path, v in nnx.to_flat_state(nnx.state(jax_model, nnx.BatchStat))}
        assert len(stats) == 4 * 2
        for name, value in stats.items():
            key = name.rsplit(".", 1)[0] + {"mean": ".running_mean",
                                            "var": ".running_var"}[name.rsplit(".", 1)[1]]
            np.testing.assert_allclose(port.state_dict()[key].numpy(), value, **TOL)
    assert all(not torch.equal(port.state_dict()[k], v) for k, v in start.items())
    got, want = _forward(jax_model, port, _x(7), train=False)
    np.testing.assert_allclose(got, want, **TOL)
