"""K4 (dense flash attention): the port's plain version against the JAX
package's Pallas kernel run in interpret mode on the CPU, the wrapper's
CPU dispatch, its gradient against ``jax.grad`` through the JAX custom VJP,
and the dispatch rule of ``dot_product_attention``. The CUDA kernel itself
is held against the plain version on a card by ``test_torch_cuda.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from routeformer_tpu.ops import attention as jax_attention
from routeformer_tpu.ops.flash_attention import flash_attention_bhle as jax_bhle
from routeformer_torch.ops import attention, flash_attention
from routeformer_torch.ops.flash_attention import attention_bhle_plain, flash_attention_bhle

SHAPES = [(2, 16, 4, 8), (1, 130, 2, 104)]  # (B, L, H, E), as test_ops_attention


def _bhle(rng, shape, e_v=None):
    """q, k, v as (B*H, L, E) numpy f32 from a (B, L, H, E) shape."""
    b, l, h, e = shape
    q, k = (rng.normal(size=(b * h, l, e)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b * h, l, e_v or e)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_plain_matches_pallas_interpret(rng, shape, causal, dtype):
    """f32 at 2e-5; bf16 (inputs rounded, f32 inside, bf16 out) at one bf16
    ulp of the O(1) outputs (2**-7)."""
    q, k, v = _bhle(rng, shape)
    scale = 1.0 / np.sqrt(shape[-1])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with pltpu.force_tpu_interpret_mode():
        want = jax_bhle(*(jnp.asarray(a, jdt) for a in (q, k, v)), causal, scale)
    got = attention_bhle_plain(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                               causal, scale)
    assert got.dtype == tdt and got.shape == q.shape
    atol = 2e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=atol)


def test_dense_plain_takes_a_narrower_value_width(rng):
    """E = 104 with E_v = 64 (the kernel pads the two apart), ragged L."""
    q, k, v = _bhle(rng, (1, 70, 3, 104), e_v=64)
    with pltpu.force_tpu_interpret_mode():
        want = jax_bhle(*map(jnp.asarray, (q, k, v)), True, 0.1)
    got = attention_bhle_plain(*map(torch.from_numpy, (q, k, v)), True, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_dense_wrapper_uses_plain_version_on_cpu(rng):
    q, k, v = map(torch.from_numpy, _bhle(rng, (2, 40, 2, 16)))
    before = flash_attention.dense_launches
    got = flash_attention_bhle(q, k, v, True, 0.25)
    assert flash_attention.dense_launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, attention_bhle_plain(q, k, v, True, 0.25),
                               rtol=0, atol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_gradient_matches_plain_autograd_and_jax(rng, causal):
    """The Function's gradients (q, k, v) equal autograd of the plain version
    and match jax.grad through the JAX custom VJP (a recompute of its f32
    reference) at 1e-5 of the largest gradient."""
    q, k, v = _bhle(rng, (2, 24, 2, 16), e_v=8)
    weight = rng.normal(size=(4, 24, 8)).astype(np.float32)
    w = torch.from_numpy(weight)

    def grads(fn):
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        return torch.autograd.grad((fn(*leaves, causal, 0.3) * w).sum(), leaves)

    got = grads(flash_attention_bhle)
    for a, b in zip(got, grads(attention_bhle_plain)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    def loss(q_, k_, v_):
        return jnp.sum(jax_bhle(q_, k_, v_, causal, 0.3) * weight)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    scale_g = max(float(np.abs(np.asarray(a)).max()) for a in want)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5 * scale_g


@pytest.mark.parametrize("mode", ["0", "1", "auto"])
def test_use_flash_follows_the_jax_rule(monkeypatch, mode):
    """The port's ``_use_flash`` against the JAX package's with its backend
    test answered "tpu" (the port has no backend test), over long and short
    keys, dropout in force or not, and weights asked for or not."""
    monkeypatch.setenv("ROUTEFORMER_FLASH", mode)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for l_k in (40, 511, 512, 1369):
        for dropout_rate, deterministic in ((0.0, True), (0.1, True), (0.1, False)):
            for need_weights in (False, True):
                args = (dropout_rate, deterministic, need_weights)
                want = jax_attention._use_flash(jnp.zeros((1, 4, 1, 8)),
                                                jnp.zeros((1, l_k, 1, 8)), *args)
                got = attention._use_flash(torch.zeros(1, 4, 1, 8),
                                           torch.zeros(1, l_k, 1, 8), *args)
                assert got == want, (mode, l_k, args)


@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_routes_long_keys_to_k4(rng, monkeypatch, causal):
    """``auto`` sends L_k >= 512 through K4's wrapper (its plain version on
    the CPU) and shorter keys through the plain einsum path; both routes
    match JAX's ``impl="flash"`` (interpret mode) in f32 at 2e-5."""
    monkeypatch.delenv("ROUTEFORMER_FLASH", raising=False)
    calls = []
    real = attention.flash_attention_bhle
    monkeypatch.setattr(attention, "flash_attention_bhle",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for l in (40, 520):
        q, k, v = (rng.normal(size=(1, l, 2, 16)).astype(np.float32) for _ in range(3))
        got = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                              causal=causal)
        with pltpu.force_tpu_interpret_mode():
            want, _ = jax_attention.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                                          causal=causal, impl="flash")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert calls == [(2, 520, 16)]
    attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), impl="plain")
    assert len(calls) == 1
    with pytest.raises(ValueError, match="impl"):
        attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), impl="jax")
