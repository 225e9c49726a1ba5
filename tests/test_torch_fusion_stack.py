"""K3a/K3b, the fused Perceive stack: the port's plain versions against the
JAX package on the CPU (``routeformer_torch/ops/fusion_stack.py`` against
``routeformer_tpu/ops/fusion_stack.py``).

The plain forward is held against the JAX twin ``stack_reference`` and the
Pallas kernel in interpret mode; the plain backward (the explicit mirror of
``_layer_bwd``, K3b's spec) against ``jax.grad`` through the Pallas
backward in interpret mode and against torch autograd of the plain
forward. Inputs come from numpy seeds; dropout masks are explicit int8
arrays handed to both. ``PerceiveEncoder`` with ``ROUTEFORMER_FUSION_KERNEL``
set runs the fused stack (plain versions on CPU tensors) against the JAX
encoder under ``interpret``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models.cross_modal import PerceiveEncoder as JaxPerceiveEncoder
from routeformer_tpu.ops import fusion_stack as jfs
from routeformer_torch.convert import flax_to_torch_names, load_flax_params
from routeformer_torch.models.cross_modal import PerceiveEncoder
from routeformer_torch.ops import fusion_stack as fs
from test_torch_models import export_params

HEADS = 8
# f32: the JAX package's own kernel-vs-twin tolerance (tests/test_fusion_stack.py).
F32_ATOL, F32_RTOL = 2e-5, 1e-5
# bf16 operands: an accumulation that differs in its last f32 bit can round
# an operand to the neighbouring bf16 value (2**-8 relative); the JAX
# fused-stack parity's forward tolerance, of the output's max.
BF16_TOL = 2e-2


def _weights(rng, n, d, f, scale=0.2):
    def rnd(*shape, s=scale):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return [rnd(n, d, d), rnd(n, d), rnd(n, d, d), rnd(n, d), rnd(n, d, d), rnd(n, d),
            rnd(n, d, d), rnd(n, d), 1.0 + rnd(n, d, s=0.05), rnd(n, d),
            rnd(n, d, f), rnd(n, f), rnd(n, f, d), rnd(n, d),
            1.0 + rnd(n, d, s=0.05), rnd(n, d)]


def _counts(rng, n, l, u_part):
    idx = rng.integers(0, l, size=(n, l, u_part))
    cnt = np.zeros((n, l, l), np.float32)
    for i in range(n):
        np.add.at(cnt[i], (np.arange(l)[:, None], idx[i]), 1.0)
    return cnt


def _masks(rng, n, r, l, d, f, p):
    return tuple((rng.uniform(size=(n, r, l, w)) >= p).astype(np.int8) for w in (d, f, d))


def _case(seed, r, l, d, f, n, train, p=0.1):
    rng = np.random.default_rng(seed)
    w = _weights(rng, n, d, f)
    x = rng.normal(size=(r, l, d)).astype(np.float32)
    u = fs.prob_sparse_u(l, 5)
    cnt = _counts(rng, n, l, u)
    masks = _masks(rng, n, r, l, d, f, p) if train else None
    return x, w, cnt, masks, u, (p if train else 0.0)


def _jnp(a):
    return None if a is None else (tuple(map(jnp.asarray, a)) if isinstance(a, (tuple, list))
                                   else jnp.asarray(a))


def _torch(a):
    return None if a is None else (tuple(map(torch.from_numpy, a)) if isinstance(a, (tuple, list))
                                   else torch.from_numpy(a))


def _close(got, want, bf16):
    got, want = np.asarray(got), np.asarray(want)
    if bf16:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)


# The shapes of the JAX package's own forward parity (test_fusion_stack.py).
SHAPES = [(10, 17, 64, 128, 3), (3, 65, 128, 256, 2), (2, 40, 64, 96, 1)]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("r,l,d,f,n", SHAPES)
def test_plain_forward_matches_jax(r, l, d, f, n, bf16, train):
    x, w, cnt, masks, u, p = _case(r * 100 + l, r, l, d, f, n, train)
    got = fs.stack_reference(_torch(x), fs.StackWeights(*_torch(w)), _torch(cnt),
                             _torch(masks), heads=HEADS, u=u, dropout_rate=p,
                             compute_bf16=bf16)
    twin = jfs.stack_reference(_jnp(x), jfs.StackWeights(*_jnp(w)), _jnp(cnt), _jnp(masks),
                               heads=HEADS, u=u, dropout_rate=p, compute_bf16=bf16)
    kernel = jfs.fused_perceive_stack(_jnp(x), jfs.StackWeights(*_jnp(w)), _jnp(cnt),
                                      _jnp(masks), heads=HEADS, dropout_rate=p,
                                      compute_bf16=bf16, interpret=True)
    assert got.shape == (r, l, d) and got.dtype == torch.float32
    _close(got.numpy(), twin, bf16)
    _close(got.numpy(), kernel, bf16)


# K3a's attention algorithm (``attention_core_tiled``): the shapes above and
# one past K3b's 208-token cap.
TILED_SHAPES = SHAPES + [(2, 240, 32, 64, 2)]
TILED_HEADS = {32: 2}  # the L > 208 case: 16-wide heads as the flagship's


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("r,l,d,f,n", TILED_SHAPES)
def test_tiled_forward_matches_jax(r, l, d, f, n, bf16, train):
    """The plain mirror of K3a's algorithm (the measure over 64-key tiles,
    the softmax and p.v only on the selected queries) against the JAX twin
    ``stack_reference`` and the Pallas kernel in interpret mode."""
    heads = TILED_HEADS.get(d, HEADS)
    x, w, cnt, masks, u, p = _case(r * 100 + l, r, l, d, f, n, train)
    got = fs.stack_reference(_torch(x), fs.StackWeights(*_torch(w)), _torch(cnt),
                             _torch(masks), heads=heads, u=u, dropout_rate=p,
                             compute_bf16=bf16, tiled=True)
    twin = jfs.stack_reference(_jnp(x), jfs.StackWeights(*_jnp(w)), _jnp(cnt), _jnp(masks),
                               heads=heads, u=u, dropout_rate=p, compute_bf16=bf16)
    kernel = jfs.fused_perceive_stack(_jnp(x), jfs.StackWeights(*_jnp(w)), _jnp(cnt),
                                      _jnp(masks), heads=heads, dropout_rate=p,
                                      compute_bf16=bf16, interpret=True)
    assert got.shape == (r, l, d) and got.dtype == torch.float32
    _close(got.numpy(), twin, bf16)
    _close(got.numpy(), kernel, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("r,l,d,f,n", TILED_SHAPES)
def test_tiled_attention_core_matches_jax(r, l, d, f, n, bf16):
    """One layer's attention output and selection from the tiled mirror
    against JAX ``_attention_core`` on the same layer input (the selection
    may differ only at a near-tie of the measure: none at these seeds)."""
    heads = TILED_HEADS.get(d, HEADS)
    x, w, cnt, _, u, _ = _case(r * 7 + l, r, l, d, f, n, False)
    mm_t, mm_j = (torch.bfloat16, jnp.bfloat16) if bf16 else (torch.float32, jnp.float32)
    wl = [a[0] for a in w[:6]]
    got, sel = fs.attention_core_tiled(_torch(x), *_torch(wl), _torch(cnt[0]), heads=heads,
                                       u=u, mm_dtype=mm_t)
    wj = [jnp.asarray(a).astype(mm_j) if a.ndim == 2 else jnp.asarray(a) for a in wl]
    want, saved = jfs._attention_core(jnp.asarray(x), *wj, jnp.asarray(cnt[0]), heads=heads,
                                      u=u, mm_dtype=mm_j)
    want_sel = np.stack([np.asarray(s)[..., 0] for s in saved[4]], axis=1)  # (C, H, L)
    np.testing.assert_array_equal(sel.numpy(), want_sel)
    _close(got.numpy().reshape(r, l, d), np.asarray(want), bf16)


def _port_grads(x, w, cnt, masks, p, bf16, backward):
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    y = fs.fused_perceive_stack(xt, fs.StackWeights(*wt), _torch(cnt), _torch(masks),
                                heads=HEADS, dropout_rate=p, compute_bf16=bf16,
                                backward=backward)
    torch.sin(y).sum().backward()
    return xt.grad.numpy(), [t.grad.numpy() for t in wt]


def _grads_close(got, want, tol_dx, tol_w):
    """dx against its max; the 16 weight grads against one global scale
    (a per-tensor scale misfires on grads that are analytically ~0, e.g.
    bk, to which softmax is blind)."""
    (dx, dw), (dx_ref, dw_ref) = got, want
    assert np.abs(dx - dx_ref).max() <= tol_dx * np.abs(dx_ref).max()
    scale = max(np.abs(a).max() for a in dw_ref)
    for a, b in zip(dw, dw_ref):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol_w * scale


@pytest.mark.parametrize("backward", ["kernel", "hybrid"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_backward_matches_pallas_interpret(bf16, train, backward):
    """dx and the 16 weight grads against jax.grad through the Pallas
    backward kernel in interpret mode. f32: 1e-5 of the scale (the JAX
    package's kernel-vs-autodiff tolerance is 1e-5 of it plus 1e-4); bf16:
    5e-2, the JAX fused-stack parity's gradient tolerance."""
    r, l, d, f, n = 5, 17, 64, 128, 2
    x, w, cnt, masks, u, p = _case(3, r, l, d, f, n, train)

    def loss(x_, w_):
        y = jfs._fused_stack(x_, w_, _jnp(cnt), _jnp(masks), HEADS, u, p, "gelu", bf16, True)
        return jnp.sum(jnp.sin(y))

    gx, gw = jax.grad(loss, argnums=(0, 1))(_jnp(x), _jnp(w))
    want = (np.asarray(gx), [np.asarray(a) for a in gw])
    got = _port_grads(x, w, cnt, masks, p, bf16, backward)
    tol = 5e-2 if bf16 else 1e-5
    _grads_close(got, want, tol, tol)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_plain_backward_matches_autograd(train):
    """K3b's spec (the explicit backward) against torch autograd of the
    plain forward, f32: the same math in another order (1e-5)."""
    r, l, d, f, n = 6, 17, 64, 128, 2
    x, w, cnt, masks, u, p = _case(5, r, l, d, f, n, train)
    got = _port_grads(x, w, cnt, masks, p, False, "kernel")
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = [torch.from_numpy(a).requires_grad_(True) for a in w]
    y = fs.stack_reference(xt, fs.StackWeights(*wt), _torch(cnt), _torch(masks),
                           heads=HEADS, u=u, dropout_rate=p, compute_bf16=False)
    torch.sin(y).sum().backward()
    _grads_close(got, (xt.grad.numpy(), [t.grad.numpy() for t in wt]), 1e-5, 1e-5)


@pytest.mark.parametrize("l,u_part", [(65, 25), (160, 30), (120, 25), (40, 20), (17, 15)])
def test_eval_count_matrices_bit_exact(l, u_part):
    """Every layer's eval counts come from PRNGKey(0), as in the JAX
    encoder; equal bit for bit."""
    n = 3
    keys = jnp.broadcast_to(jax.random.PRNGKey(0)[None], (n, 2))
    want = np.asarray(jfs.sample_count_matrices(keys, n, l, l, u_part))
    got = fs.sample_count_matrices(n, l, l, u_part).numpy()
    np.testing.assert_array_equal(got, want)


def test_train_count_matrices_and_masks():
    """Train draws: per-layer counts summing to ``u_part`` per query, and
    int8 keep-masks at the rate asked, both repeatable from a generator."""
    n, l, u_part = 4, 40, 20
    cnt = fs.sample_count_matrices(n, l, l, u_part, train=True,
                                   generator=torch.Generator().manual_seed(1))
    again = fs.sample_count_matrices(n, l, l, u_part, train=True,
                                     generator=torch.Generator().manual_seed(1))
    assert cnt.shape == (n, l, l) and cnt.dtype == torch.float32
    assert torch.equal(cnt, again)
    assert torch.all(cnt.sum(-1) == u_part)
    assert not torch.equal(cnt[0], cnt[1])  # fresh per layer
    masks = fs.make_dropout_masks(n, 8, l, 64, 128, 0.1,
                                  generator=torch.Generator().manual_seed(2))
    assert [m.shape for m in masks] == [(n, 8, l, 64), (n, 8, l, 128), (n, 8, l, 64)]
    for m in masks:
        assert m.dtype == torch.int8 and set(m.unique().tolist()) <= {0, 1}
        assert abs(m.float().mean().item() - 0.9) < 0.01  # 1e5+ draws: 3 sigma ~ 3e-3


def test_wrapper_rejects_unknown_modes():
    x, w, cnt, masks, _, p = _case(0, 2, 9, 64, 96, 1, False)
    with pytest.raises(ValueError):
        fs.fused_perceive_stack(_torch(x), fs.StackWeights(*_torch(w)), _torch(cnt), None,
                                heads=HEADS, backward="xla")
    with pytest.raises(ValueError):
        fs.fused_perceive_stack(_torch(x), fs.StackWeights(*_torch(w)), _torch(cnt), None,
                                heads=HEADS, activation="swish")


@pytest.mark.parametrize("dh", [8, 16, 32, 64])
def test_max_tokens_fwd_is_the_largest_l_that_fits(dh):
    """K3a's token limit: the largest L whose select block (the rank test's
    L measures in shared memory) fits, far above the DinoV2 frame
    encoder's 1370 and K3b's cap."""
    want = max(l for l in range(1, 40000, 1) if fs.select_smem_bytes(l, dh) <= fs.SMEM_BYTES)
    assert fs.max_tokens_fwd(dh) == want
    assert want > 1370 and want > fs.max_tokens(dh)


def _stack_case(l, train):
    x, w, cnt, masks, _, p = _case(l, 2, l, 64, 96, 2, train)
    return (_torch(x), fs.StackWeights(*_torch(w)), _torch(cnt), _torch(masks), p)


@pytest.mark.parametrize("l", [240, 1370])
def test_checks_split_k3a_takes_long_rows_k3b_refuses(l):
    """The split checks: K3a's check takes L past K3b's cap (1370 tokens at
    16-wide heads); K3b's raises a ValueError naming its cap, and so does a
    kernel-backward stack that needs a gradient, before any launch."""
    x, w, cnt, masks, p = _stack_case(l, train=False)
    fs._check_fwd(x, w, cnt, masks, heads=4)  # D 64 / 4 heads: 16-wide, as the flagship's
    with pytest.raises(ValueError, match=f"at most {fs.max_tokens(16)} tokens"):
        fs._check_bwd(x, heads=4)
    before = fs.launches_bwd
    with pytest.raises(ValueError, match="at most 208 tokens"):
        fs.layer_backward_cuda(x, torch.zeros_like(x), tuple(t[0] for t in w), cnt[0], None,
                               heads=4, u=10, dropout_rate=0.0, activation="gelu",
                               compute_bf16=False)
    assert fs.launches_bwd == before


def test_checks_refuse_what_k3a_does_not_take():
    x, w, cnt, masks, p = _stack_case(17, train=True)
    fs._check_fwd(x, w, cnt, masks, heads=4)
    with pytest.raises(ValueError, match="D = 128"):
        fs._check_fwd(x, w, cnt, masks, heads=4, compute_bf16=True)
    with pytest.raises(ValueError, match="f32"):
        fs._check_fwd(x.double(), w, cnt, masks, heads=4)
    with pytest.raises(ValueError, match="cnt"):
        fs._check_fwd(x, w, cnt[:, :10], masks, heads=4)
    with pytest.raises(ValueError, match="masks"):
        fs._check_fwd(x, w, cnt, tuple(m[:1] for m in masks), heads=4)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros(1, fs.max_tokens_fwd(16) + 1, 64)
        fs._check_fwd(big, w, torch.zeros(2, 1, 1).expand(2, big.shape[1], big.shape[1]),
                      None, heads=4)


def test_kernel_weights_concatenate_and_transpose():
    """The kernels' derived weights: q|k|v side by side in f32, and the
    bf16 (out, in) matrices of the TMA-fed GEMMs, for a stack and for one
    layer."""
    x, w, cnt, masks, p = _stack_case(17, train=False)
    kw = fs.kernel_weights(w)
    assert kw.wqkv.shape == (2, 64, 192) and kw.bqkv.shape == (2, 192)
    torch.testing.assert_close(kw.wqkv[1, :, 64:128], w.wk[1], rtol=0, atol=0)
    torch.testing.assert_close(kw.bqkv[0, 128:], w.bv[0], rtol=0, atol=0)
    assert kw.wout_t.dtype == kw.wff2_t.dtype == kw.wqkv_t.dtype == torch.bfloat16
    assert kw.wff2_t.shape == (2, 64, 96) and kw.wff2_t.is_contiguous()
    assert kw.wqkv_t.shape == (2, 192, 64) and kw.wff1_t.shape == (2, 96, 64)
    torch.testing.assert_close(kw.wqkv_t[0].float(), kw.wqkv[0].t().bfloat16().float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(kw.wff1_t[1].float(), w.wff1[1].t().bfloat16().float(),
                               rtol=0, atol=0)
    torch.testing.assert_close(kw.wout_t[1].float(), w.wout[1].t().bfloat16().float(),
                               rtol=0, atol=0)
    one = fs.kernel_weights(tuple(t[1] for t in w))
    for a, b in zip(one, kw):
        torch.testing.assert_close(a, b[1], rtol=0, atol=0)


@pytest.mark.parametrize("dh", [8, 16, 32, 64])
def test_max_tokens_is_the_largest_l_that_fits(dh):
    """The token limit the kernels' wrappers raise at is the largest L whose
    attention block fits a block's shared memory (208 at the d128 / 8-head
    width, below the DinoV2 frame encoder's 1370)."""
    want = max(l for l in range(1, 400) if fs.attn_smem_bytes(l, dh) <= fs.SMEM_BYTES)
    assert fs.max_tokens(dh) == want
    if dh == 16:
        assert want == 208


def _encoder_pair(rng, compute_dtype):
    kw = dict(factor=1000, d_model=64, n_heads=HEADS, layers=2, d_ff=96, dropout=0.0,
              compute_dtype=compute_dtype)
    jax_enc = JaxPerceiveEncoder(5, 16, 4, rngs=nnx.Rngs(0), **kw)
    port = PerceiveEncoder(5, 16, 4, **kw)
    load_flax_params(port, export_params(jax_enc, rng))
    return jax_enc, port


@pytest.mark.parametrize("mode", ["1", "hybrid"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_perceive_encoder_fused_matches_jax(rng, monkeypatch, mode, compute_dtype):
    """The encoder's fused path (plain versions on the CPU) against the JAX
    encoder with its kernels in interpret mode: the eval output, and in
    training (dropout 0, exhaustive ProbSparse, so no random draw matters)
    the gradients of the input and of every parameter."""
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", mode)
    jax_enc, port = _encoder_pair(rng, compute_dtype)
    assert port.fused_kernel_mode() == ("hybrid" if mode == "hybrid" else "kernel")
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL",
                       "hybrid-interpret" if mode == "hybrid" else "interpret")
    assert jax_enc._fused_kernel_mode() is not None
    x = rng.normal(size=(3, 24, 5)).astype(np.float32)
    tol = 2e-2 if compute_dtype else 1e-4

    jax_enc.eval()
    port.eval()
    want = np.asarray(jax_enc(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 4, 16)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()

    jax_enc.train()
    port.train()

    def loss(m, x_):
        return jnp.sum(jnp.sin(m(x_)))

    gm, gx = nnx.grad(loss, argnums=(0, 1))(jax_enc, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sin(port(xt)).sum().backward()
    assert np.abs(xt.grad.numpy() - np.asarray(gx)).max() <= tol * np.abs(np.asarray(gx)).max()
    want_g = flax_to_torch_names({".".join(str(k) for k in path): np.asarray(v[...])
                                  for path, v in nnx.to_flat_state(gm)})
    got_g = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(got_g) == set(want_g)
    scale = max(np.abs(g).max() for g in want_g.values())
    for k, g in want_g.items():
        assert np.abs(got_g[k] - g).max() <= tol * scale, k


@pytest.mark.parametrize("compute_dtype,factor", [(None, 5), ("bfloat16", 1000)],
                         ids=["f32-u", "bf16-exhaustive"])
def test_perceive_encoder_fused_long_rows_match_jax(rng, monkeypatch, compute_dtype, factor):
    """An encoder at 240 tokens (past K3b's cap, as the DinoV2 frame
    encoder's 1370 are) with ROUTEFORMER_FUSION_KERNEL=1 against the JAX
    encoder with its kernel in interpret mode, eval: f32 with the real u
    (the fixed eval key sample, bit-exact in both) and bf16 exhaustive."""
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    kw = dict(factor=factor, d_model=32, n_heads=2, layers=2, d_ff=64, dropout=0.0,
              compute_dtype=compute_dtype)
    jax_enc = JaxPerceiveEncoder(5, 16, 4, rngs=nnx.Rngs(0), **kw)
    port = PerceiveEncoder(5, 16, 4, **kw)
    load_flax_params(port, export_params(jax_enc, rng))
    assert port.fused_kernel_mode() == "kernel"
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "interpret")
    x = rng.normal(size=(2, 240, 5)).astype(np.float32)
    jax_enc.eval()
    port.eval()
    want = np.asarray(jax_enc(jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    tol = 2e-2 if compute_dtype else 1e-4
    assert got.shape == want.shape == (2, 4, 16)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_perceive_encoder_caches_stacked_weights(rng):
    """The encoder's stacked weights and the kernels' derived ones are built
    once and reused; an in-place update of a layer parameter (an optimizer
    step) and ``load_flax_params`` rebuild both with the new values; while
    autograd records, the stacked weights are built afresh (their gradient
    reaches the parameters) and the derived ones still come from the cache."""
    _, port = _encoder_pair(rng, None)
    with torch.no_grad():
        w, kw = port.stack_weights(), port.kernel_weights()
        assert port.stack_weights() is w and port.kernel_weights() is kw
        torch.testing.assert_close(kw.wqkv, fs.kernel_weights(w).wqkv, rtol=0, atol=0)
        port.stacked_layers[1].attention.key_projection.weight.mul_(2.0)
        w2, kw2 = port.stack_weights(), port.kernel_weights()
        assert w2 is not w and kw2 is not kw
        torch.testing.assert_close(
            w2.wk[1], port.stacked_layers[1].attention.key_projection.weight.t(), rtol=0, atol=0)
        torch.testing.assert_close(kw2.wqkv[1, :, 64:128], w2.wk[1], rtol=0, atol=0)
    fresh_jax, _ = _encoder_pair(rng, None)
    load_flax_params(port, export_params(fresh_jax, rng))
    with torch.no_grad():
        w3, kw3 = port.stack_weights(), port.kernel_weights()
        assert w3 is not w2 and kw3 is not kw2
        torch.testing.assert_close(
            w3.wq[0], port.stacked_layers[0].attention.query_projection.weight.t(), rtol=0, atol=0)
        torch.testing.assert_close(kw3.wout_t, fs.kernel_weights(w3).wout_t, rtol=0, atol=0)
    recorded = port.stack_weights()
    assert recorded is not w3 and recorded.wq.requires_grad
    assert port.kernel_weights() is kw3
    recorded.wq.sum().backward()
    assert port.stacked_layers[0].attention.query_projection.weight.grad is not None


def test_perceive_encoder_switch_values(monkeypatch):
    """The JAX package's values: unset/0/auto the plain stack; hybrid* the
    recompute backward; anything else the kernel backward; only the masked
    ProbSparse formulation is fused."""
    port = PerceiveEncoder(5, 16, 4, d_model=64, n_heads=HEADS, layers=1)
    monkeypatch.delenv("ROUTEFORMER_FUSION_KERNEL", raising=False)
    assert port.fused_kernel_mode() is None
    for value, mode in [("0", None), ("auto", None), ("1", "kernel"), ("tpu", "kernel"),
                        ("interpret", "kernel"), ("hybrid", "hybrid"),
                        ("hybrid-interpret", "hybrid")]:
        monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", value)
        assert port.fused_kernel_mode() == mode, value
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    monkeypatch.setenv("ROUTEFORMER_PROBSPARSE", "gather")
    assert port.fused_kernel_mode() is None
