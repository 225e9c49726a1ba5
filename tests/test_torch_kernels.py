"""K1 (fused SwinV2 block) and K2 (window attention): the port's plain
versions against the JAX package's Pallas kernels run in interpret mode on
the CPU, and the wrappers' CPU dispatch. The CUDA kernels themselves are
held against the plain versions on a card by ``test_torch_cuda.py``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from routeformer_tpu.ops.flash_attention import flash_window_attention as jax_window
from routeformer_tpu.ops.swin_block_fusion import fused_swin_block as jax_block
from routeformer_tpu.ops.swin_block_fusion import fused_swin_block_forward
from routeformer_torch.ops import flash_attention, swin_block_fusion
from routeformer_torch.ops.flash_attention import (
    flash_window_attention,
    flash_window_attention_plain,
)
from routeformer_torch.ops.swin_block_fusion import (
    fused_swin_block,
    fused_swin_block_plain,
)

_TORCH_LAYOUT = ("wqkv", "wproj", "wfc1", "wfc2")


def _window_inputs(rng, b, h, n, d, nb):
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(nb, h, n, n)).astype(np.float32)
    scale = np.exp(np.minimum(rng.normal(size=(h,)) * 0.5 + 2.3,
                              math.log(100.0))).astype(np.float32)
    return q, k, v, bias, scale


def _block_inputs(rng, b, n, c, h, nw):
    """JAX-layout params (kernels (in, out)), window rows and the bias."""
    def rnd(*shape, s=0.15):
        return (rng.normal(size=shape) * s).astype(np.float32)

    p = {
        "wqkv": rnd(c, 3 * c), "bqkv": rnd(3 * c), "wproj": rnd(c, c),
        "bproj": rnd(c), "ln1_scale": 1 + rnd(c, s=0.05),
        "ln1_bias": rnd(c, s=0.05), "wfc1": rnd(c, 4 * c), "bfc1": rnd(4 * c),
        "wfc2": rnd(4 * c, c), "bfc2": rnd(c), "ln2_scale": 1 + rnd(c, s=0.05),
        "ln2_bias": rnd(c, s=0.05),
        "logit_scale": np.exp(np.minimum(rnd(h, s=0.5) + 2.3, math.log(100.0))),
    }
    x = rng.normal(size=(b, n, c)).astype(np.float32)
    bias = rnd(h, n, n, s=1.0)
    if nw is not None:  # shifted block: a -100 mask per window kind
        mask = np.where(rng.uniform(size=(nw, n, n)) < 0.2, -100.0, 0.0)
        bias = (bias[None] + mask[:, None]).astype(np.float32)
    return x, p, bias


def _torch_params(p):
    return {k: torch.from_numpy(np.ascontiguousarray(v.T if k in _TORCH_LAYOUT else v))
            for k, v in p.items()}


# ----------------------------------------------------------------- K2 --- #


@pytest.mark.parametrize("cosine", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_plain_matches_pallas_interpret(rng, cosine, dtype):
    """bias[b % NB] broadcast (3 repeats of 4 window kinds), ragged n = 20;
    f32 at 2e-5, bf16 (bf16 operands, f32 accumulate and softmax) at one
    bf16 ulp of the O(1) outputs (2**-7)."""
    q, k, v, bias, scale = _window_inputs(rng, 12, 2, 20, 16, 4)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with pltpu.force_tpu_interpret_mode():
        want = jax_window(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          jnp.asarray(bias), jnp.asarray(scale), cosine=cosine)
    got = flash_window_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(bias), torch.from_numpy(scale), cosine=cosine)
    assert got.dtype == tdt
    atol = 2e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=atol)


def test_window_wrapper_uses_plain_version_on_cpu(rng):
    q, k, v, bias, scale = map(torch.from_numpy, _window_inputs(rng, 4, 2, 16, 16, 2))
    before = flash_attention.launches
    got = flash_window_attention(q, k, v, bias, scale, cosine=True)
    assert flash_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(
        got, flash_window_attention_plain(q, k, v, bias, scale, cosine=True))


# ----------------------------------------------------------------- K1 --- #


@pytest.mark.parametrize("b,n,c,h,nw", [
    (3, 64, 128, 4, None), (2, 64, 256, 8, None), (4, 16, 64, 4, 2),
])
def test_block_plain_f32_matches_pallas_interpret(rng, b, n, c, h, nw):
    """compute_bf16=False: the f32 reference block, at 5e-5."""
    x, p, bias = _block_inputs(rng, b, n, c, h, nw)
    want = fused_swin_block_forward(jnp.asarray(x), p, n_heads=h,
                                    bias=jnp.asarray(bias), compute_bf16=False,
                                    interpret=True)
    got = fused_swin_block_plain(torch.from_numpy(x), _torch_params(p),
                                 torch.from_numpy(bias), h, compute_bf16=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("nw", [None, 2])
def test_block_plain_bf16_matches_pallas_interpret(rng, nw):
    """compute_bf16=True rounds matmul operands at the kernel's points; the
    two differ only by f32 summation order, which can flip a bf16 rounding
    of an intermediate: max error within 1e-2 of the output's max."""
    x, p, bias = _block_inputs(rng, 4, 16, 64, 4, nw)
    want = np.asarray(fused_swin_block_forward(
        jnp.asarray(x), p, n_heads=4, bias=jnp.asarray(bias),
        compute_bf16=True, interpret=True))
    got = fused_swin_block_plain(torch.from_numpy(x), _torch_params(p),
                                 torch.from_numpy(bias), 4, compute_bf16=True).numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_block_wrapper_uses_plain_version_on_cpu(rng):
    x, p, bias = _block_inputs(rng, 2, 16, 64, 4, None)
    tp = _torch_params(p)
    before = swin_block_fusion.launches
    got = fused_swin_block(torch.from_numpy(x), tp, torch.from_numpy(bias), 4, False)
    assert swin_block_fusion.launches == before
    torch.testing.assert_close(
        got, fused_swin_block_plain(torch.from_numpy(x), tp, torch.from_numpy(bias), 4, False))


@pytest.mark.parametrize("nw", [None, 2])
def test_block_jax_names_match_jax(rng, nw):
    """``fused_swin_block_forward`` (no autograd; f32 at 5e-5, bf16 within
    1e-2 of the max as above) and ``swin_block_reference`` (at 5e-5)
    against the JAX functions of those names."""
    from routeformer_tpu.ops.swin_block_fusion import swin_block_reference as jax_reference

    x, p, bias = _block_inputs(rng, 4, 16, 64, 4, nw)
    tx, tp, tb = torch.from_numpy(x), _torch_params(p), torch.from_numpy(bias)
    for bf16, tol in ((False, 5e-5), (True, 1e-2)):
        want = np.asarray(fused_swin_block_forward(jnp.asarray(x), p, n_heads=4,
                                                   bias=jnp.asarray(bias), compute_bf16=bf16,
                                                   interpret=True))
        tx.requires_grad_(True)
        got = swin_block_fusion.fused_swin_block_forward(tx, tp, n_heads=4, bias=tb,
                                                         compute_bf16=bf16)
        assert not got.requires_grad
        scale = 1.0 if not bf16 else np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= tol * scale, bf16
    want = np.asarray(jax_reference(jnp.asarray(x), p, n_heads=4, bias=jnp.asarray(bias)))
    got = swin_block_fusion.swin_block_reference(tx, tp, n_heads=4, bias=tb)
    assert got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want, atol=5e-5, rtol=1e-5)


# ------------------------------------------------------ K1/K2 gradients --- #


def _grads(fn, leaves, weight):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves)
    return torch.autograd.grad((out.float() * weight).sum(), leaves)


def test_window_gradient_matches_plain_autograd_and_jax(rng):
    """K2's autograd Function on CPU tensors: its gradients (q, k, v, bias,
    scale) equal autograd of the plain version, and match jax.grad through
    the JAX package's custom VJP (a recompute of its f32 reference) at
    1e-5 of the largest gradient."""
    q, k, v, bias, scale = _window_inputs(rng, 6, 2, 20, 16, 3)
    weight = rng.normal(size=q.shape).astype(np.float32)
    leaves = [torch.from_numpy(a) for a in (q, k, v, bias, scale)]
    w = torch.from_numpy(weight)
    got = _grads(lambda *t: flash_window_attention(*t, cosine=True), leaves, w)
    plain = _grads(lambda *t: flash_window_attention_plain(*t, cosine=True), leaves, w)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    def loss(*t):
        return jnp.sum(jax_window(*t, cosine=True) * weight)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=tuple(range(5)))(*map(jnp.asarray, (q, k, v, bias, scale)))
    scale_g = max(float(np.abs(np.asarray(a)).max()) for a in want)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5 * scale_g


@pytest.mark.parametrize("nw", [None, 2])
def test_block_gradient_matches_plain_autograd_and_jax(rng, nw):
    """K1's autograd Function on CPU tensors: the gradients of the rows, the
    bias and all 13 parameters equal autograd of the f32 plain version, and
    match jax.grad through the JAX package's custom VJP (over
    ``swin_block_reference``) at 1e-5 of the largest gradient."""
    x, p, bias = _block_inputs(rng, 4, 16, 64, 4, nw)
    keys = swin_block_fusion.PARAM_KEYS
    tp = _torch_params(p)
    weight = rng.normal(size=x.shape).astype(np.float32)
    leaves = [torch.from_numpy(x), torch.from_numpy(bias), *(tp[k] for k in keys)]
    w = torch.from_numpy(weight)
    got = _grads(lambda x_, b_, *ps: fused_swin_block(x_, dict(zip(keys, ps)), b_, 4, True),
                 leaves, w)
    plain = _grads(lambda x_, b_, *ps: fused_swin_block_plain(x_, dict(zip(keys, ps)), b_, 4,
                                                              compute_bf16=False),
                   leaves, w)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)

    def loss(x_, b_, ps):
        return jnp.sum(jax_block(x_, ps, b_, 4, True, True) * weight)

    gx, gb, gp = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(bias), {k: jnp.asarray(v) for k, v in p.items()})
    want = [gx, gb, *(np.asarray(gp[k]).T if k in _TORCH_LAYOUT else gp[k] for k in keys)]
    scale_g = max(float(np.abs(np.asarray(a)).max()) for a in want)
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5 * scale_g
