"""Autoformer against the JAX package on the CPU: the AutoCorrelation op in
training (delays shared by the batch) and eval (per row), with the keys
longer and shorter than the queries and on exact ties; the moving average
and both decompositions; the Autoformer backbone in train and eval mode and
with ``output_attention`` (its correlation maps at 1e-5 of their max) and
a train-mode gradient (1e-5 of the largest gradient). Every parameter is carried
by ``load_flax_params``. f32 at atol/rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models.gps_backbone import GPSBackboneConfig as JaxGPSConfig
from routeformer_tpu.models.gps_backbone.autoformer import Autoformer as JaxAutoformer
from routeformer_tpu.models.layers.autoformer_layers import SeriesDecompMulti as JaxDecompMulti
from routeformer_tpu.models.layers.autoformer_layers import (
    autoformer_moving_avg as jax_moving_avg,
)
from routeformer_tpu.ops.attention import autocorrelation_attention as jax_autocorrelation
from routeformer_torch.convert import flax_to_torch_names, load_flax_params
from routeformer_torch.models.gps_backbone import Autoformer, GPSBackboneConfig
from routeformer_torch.models.layers.autoformer_layers import (
    SeriesDecomp,
    SeriesDecompMulti,
    autoformer_moving_avg,
)
from routeformer_torch.ops.attention import autocorrelation_attention
from test_torch_models import export_params
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)

B, SEQ_LEN, LABEL_LEN, PRED_LEN, ENC_IN = 3, 20, 20, 10, 7
TOL = dict(atol=1e-4, rtol=1e-4)


def gps_kwargs(**kw):
    return dict(dict(seq_len=SEQ_LEN, label_len=LABEL_LEN, pred_len=PRED_LEN, d_model=64,
                     n_heads=4, e_layers=2, d_layers=1, d_ff=128, dropout=0.0, factor=2,
                     moving_avg=5, activation="relu", _enc_in=ENC_IN, _c_out=3), **kw)


def _qkv(seed, l, s, h=2, e=8):
    r = np.random.RandomState(seed)
    return (r.randn(B, l, h, e).astype(np.float32), r.randn(B, s, h, e).astype(np.float32),
            r.randn(B, s, h, e).astype(np.float32))


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("l,s", [(20, 20), (24, 16), (16, 24)], ids=["equal", "l>s", "l<s"])
def test_autocorrelation_matches_jax(training, l, s):
    q, k, v = _qkv(l * 100 + s, l, s)
    want, want_corr = jax_autocorrelation(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          factor=2, training=training)
    got, corr = autocorrelation_attention(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), factor=2, training=training)
    assert got.shape == (B, l, 2, 8)
    np.testing.assert_allclose(corr.numpy(), np.asarray(want_corr), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_autocorrelation_ties_take_the_lower_delay(training):
    """Constant queries make every delay's correlation equal: the lower
    delays win, in JAX's top_k order, and the output is their mean."""
    q = np.ones((B, 12, 2, 4), np.float32)
    _, k, v = _qkv(5, 12, 12, e=4)
    k = np.repeat(k[:, :1], 12, axis=1)  # constant keys: a flat correlation
    want, _ = jax_autocorrelation(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  factor=3, training=training)
    got, _ = autocorrelation_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), factor=3, training=training)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    top_k = int(3 * np.log(12))
    lower = np.mean([np.roll(v, -d, axis=1) for d in range(top_k)], axis=0)
    np.testing.assert_allclose(got.numpy(), lower, **TOL)


@pytest.mark.parametrize("kernel", [25, 5, 4])
def test_moving_average_and_decomp_match_jax(kernel):
    x = np.random.RandomState(kernel).randn(B, SEQ_LEN, ENC_IN).astype(np.float32)
    want = np.asarray(jax_moving_avg(jnp.asarray(x), kernel))
    np.testing.assert_allclose(autoformer_moving_avg(torch.from_numpy(x), kernel).numpy(),
                               want, **TOL)
    res, trend = SeriesDecomp(kernel)(torch.from_numpy(x))
    np.testing.assert_allclose(trend.numpy(), want, **TOL)
    np.testing.assert_allclose(res.numpy(), x - want, **TOL)


def test_decomp_multi_matches_jax(rng):
    jax_mod = JaxDecompMulti([3, 5, 8], rngs=nnx.Rngs(0))
    port = SeriesDecompMulti([3, 5, 8])
    load_flax_params(port, export_params(jax_mod, rng))
    x = np.random.RandomState(2).randn(B, SEQ_LEN, ENC_IN).astype(np.float32)
    want = jax_mod(jnp.asarray(x))
    got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


def autoformer_pair(rng, **kw):
    jax_model = JaxAutoformer(JaxGPSConfig(**gps_kwargs(**kw)), rngs=nnx.Rngs(0, dropout=1))
    port = Autoformer(GPSBackboneConfig(**gps_kwargs(**kw)))
    n = load_flax_params(port, export_params(jax_model, rng))
    assert n == len(port.state_dict())
    return jax_model, port


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_autoformer_matches_jax(rng, train):
    jax_model, port = autoformer_pair(rng)
    jax_model.train() if train else jax_model.eval()
    port.train(train)
    x = np.random.RandomState(3).randn(B, SEQ_LEN, ENC_IN).astype(np.float32)
    want = np.asarray(nnx.jit(lambda m, a: m(a))(jax_model, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (B, PRED_LEN, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_autoformer_output_attention_and_gradient_match_jax(rng):
    """``output_attention`` returns each encoder layer's correlation map;
    the train-mode gradient of a sum of the output matches JAX's."""
    jcfg, cfg = JaxGPSConfig(**gps_kwargs()), GPSBackboneConfig(**gps_kwargs())
    jcfg.output_attention = cfg.output_attention = True
    jax_model = JaxAutoformer(jcfg, rngs=nnx.Rngs(0, dropout=1))
    port = Autoformer(cfg)
    load_flax_params(port, export_params(jax_model, rng))
    x = np.random.RandomState(4).randn(B, SEQ_LEN, ENC_IN).astype(np.float32)
    jax_model.eval()
    port.eval()
    want, want_attn = nnx.jit(lambda m, a: m(a))(jax_model, jnp.asarray(x))
    with torch.no_grad():
        got, attn = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(attn) == len(want_attn) == 2
    for a, w in zip(attn, want_attn):  # correlations of magnitude ~1e3: 1e-5 of the max
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)

    jcfg.output_attention = cfg.output_attention = False
    jax_model = JaxAutoformer(jcfg, rngs=nnx.Rngs(0, dropout=1))
    port = Autoformer(cfg)
    load_flax_params(port, export_params(jax_model, rng))
    jax_model.train()
    port.train()
    graphdef, params, rest = nnx.split(jax_model, nnx.Param, ...)

    def loss(p):
        return (nnx.merge(graphdef, p, rest)(jnp.asarray(x)) ** 2).sum()

    want_grads = nnx.to_flat_state(jax.jit(jax.grad(loss))(params))
    (port(torch.from_numpy(x)) ** 2).sum().backward()
    grads = dict(port.named_parameters())
    flat = {".".join(map(str, k)): np.asarray(v[...]) for k, v in want_grads}
    scale = max(np.abs(g).max() for g in flat.values())
    for name, g in flax_to_torch_names(flat).items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
