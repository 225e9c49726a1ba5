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
    """``auto`` sends L_k >= 512 through K4's wrapper on the (B, L, H, E)
    views, ``dense_attention_blhe`` (its plain version on the CPU, the same
    route the card takes), and shorter keys through the plain einsum path;
    both routes match JAX's ``impl="flash"`` (interpret mode) in f32 at
    2e-5."""
    monkeypatch.delenv("ROUTEFORMER_FLASH", raising=False)
    calls = []
    real = attention.dense_attention_blhe
    monkeypatch.setattr(attention, "dense_attention_blhe",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    for l in (40, 520):
        q, k, v = (rng.normal(size=(1, l, 2, 16)).astype(np.float32) for _ in range(3))
        got = attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                              causal=causal)
        with pltpu.force_tpu_interpret_mode():
            want, _ = jax_attention.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                                          causal=causal, impl="flash")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert calls == [(1, 520, 2, 16)]
    attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), impl="plain")
    assert len(calls) == 1
    with pytest.raises(ValueError, match="impl"):
        attention.dot_product_attention(*map(torch.from_numpy, (q, k, v)), impl="jax")


@pytest.mark.parametrize("causal", [False, True])
def test_dense_views_route_matches_jax_and_bhle(rng, causal):
    """``dense_attention_blhe``, the card's route of ``dot_product_attention``,
    on strided (B, L, H, E) views of one qkv buffer: on the CPU it is the
    plain version, equal to the head-flattened route bit for bit, within
    2e-5 of JAX's ``impl="flash"`` (interpret mode), and differentiable."""
    qkv = torch.from_numpy(rng.normal(size=(2, 520, 3, 2, 16)).astype(np.float32))
    qkv.requires_grad_(True)
    q, k, v = qkv.unbind(2)
    got = flash_attention.dense_attention_blhe(q, k, v, causal, 0.25)
    flat = [t.transpose(1, 2).reshape(4, 520, 16) for t in (q, k, v)]
    want = flash_attention_bhle(*flat, causal, 0.25).reshape(2, 2, 520, 16).transpose(1, 2)
    assert got.shape == (2, 520, 2, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pltpu.force_tpu_interpret_mode():
        jax_out, _ = jax_attention.dot_product_attention(
            *(jnp.asarray(t.detach().numpy()) for t in (q, k, v)), causal=causal,
            scale=0.25, impl="flash")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jax_out), atol=2e-5)
    got.sum().backward()
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()


@pytest.mark.parametrize("case", ["bf16 views", "f32 views", "bf16 E 12", "bf16 off 16 bytes"])
def test_dense_operand_copies_only_what_k4_cannot_read(case):
    """K4 reads an operand in place when E has unit stride and, in bf16, E
    is a multiple of 8 and every row starts on 16 bytes; otherwise the
    wrapper copies it, zero-padding a bf16 E to a multiple of 8."""
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    e = 12 if case == "bf16 E 12" else 64
    buf = torch.arange(2 * 9 * 3 * 4 * e + 1, dtype=torch.float32).to(dtype)
    start = 1 if case == "bf16 off 16 bytes" else 0
    t = buf[start:start + 2 * 9 * 3 * 4 * e].view(2, 9, 3, 4, e)[:, :, 1].transpose(1, 2)
    got = flash_attention._dense_operand(t)
    if case in ("bf16 views", "f32 views"):
        assert got is t
        return
    assert got.is_contiguous() and got.shape[-1] == -(-e // 8) * 8
    torch.testing.assert_close(got[..., :e], t, rtol=0, atol=0)
    assert (got[..., e:] == 0).all()
