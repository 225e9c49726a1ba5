"""K3a/K3b: the fused Perceive-encoder stack (counterpart of
``routeformer_tpu/ops/fusion_stack.py``).

N identical d128 ProbSparse encoder layers over independent rows ``(R, L,
D)``: QKV, the count-matrix sparsity measure, the rank-test top-u
selection, f32 softmax and p.v (mean-V rows for the unselected queries),
out-projection with dropout, LayerNorm, the FFN with the erf gelu, LayerNorm.

- ``stack_reference`` / ``layer_forward`` are the plain forward, and
  ``layer_backward`` the plain backward: an explicit mirror of the JAX
  package's ``_layer_bwd`` (not autograd), the executable spec of K3b.
  ``attention_core_tiled`` mirrors K3a's attention algorithm (the measure
  accumulated over key tiles, the softmax and p.v only on the selected
  queries); ``tiled=True`` runs the layers through it.
- K3a (``csrc/perceive_stack.cu``, ``rf_perceive_stack_fwd``) runs all N
  layers forward over all rows in one call, at any L whose measures fit a
  block's shared memory (``max_tokens_fwd``); K3b (``rf_perceive_layer_bwd``)
  recomputes one layer from its saved input with K3a's attention core,
  differentiates the selection that core made, and returns dx and the 16
  weight grads summed over all rows in f32, in a fixed order (two runs give
  the same bits); its attention block holds an L x L tile and takes at most
  ``max_tokens`` tokens. Their GEMMs run on the Hopper GEMM core
  (``csrc/gemm_sm90.cuh``); ``kernel_weights`` derives the concatenated
  q|k|v weights and the bf16 (out, in) copies of the forward's four weight
  matrices that they read;
  ``split_rows`` and ``workspace_floats`` plan the weight-gradient
  products' splits and the workspace (one buffer per device, grown to the
  largest call and reused: the calls run in order on the current stream),
  and ``gemm_core`` runs the layer's GEMM on its own. ``launches_fwd`` /
  ``launches_bwd`` count one per layer.
- K3a is the registered op ``routeformer::perceive_stack`` (CUDA:
  ``stack_forward_cuda``; CPU: the plain layers), so ``torch.export``
  traces the serving forward through it.
- ``fused_perceive_stack`` wires them under autograd: ``backward="kernel"``
  runs K3b layer by layer in reverse from the per-layer inputs (the only
  residual, which K3a writes into one (N, R, L, D) buffer); ``"hybrid"``
  runs autograd over the plain layer forward.

Tensors on the CPU take the plain versions; CUDA tensors take the kernels
(a build or launch failure raises). ``StackWeights`` are in the JAX layout,
``(in, out)`` matrices stacked over layers. Numerics follow the JAX code:
LayerNorm with the fast variance ``max(E[x^2] - mu^2, 0)`` and eps 1e-6;
gelu through XLA's rational erf; the measure ``max - sum / L_k``; the rank
test keeps ties; matmul operands in the compute dtype with f32
accumulation, but p.v and the mean-V context f32 x f32.
"""

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from routeformer_torch.ops import cuda_build
from routeformer_torch.utils.prng import prob_sparse_index_sample

_NEG_INF = -1e30
_LN_EPS = 1e-6
_ACT = {"gelu": 1, "relu": 2}

launches_fwd = 0
launches_bwd = 0


class StackWeights(NamedTuple):
    """Stacked per-layer parameters, leading axis = layer, (in, out) matrices."""

    wq: torch.Tensor  # (N, D, D)
    bq: torch.Tensor  # (N, D)
    wk: torch.Tensor
    bk: torch.Tensor
    wv: torch.Tensor
    bv: torch.Tensor
    wout: torch.Tensor  # (N, D, D)
    bout: torch.Tensor  # (N, D)
    ln1_scale: torch.Tensor  # (N, D)
    ln1_bias: torch.Tensor
    wff1: torch.Tensor  # (N, D, F)
    bff1: torch.Tensor  # (N, F)
    wff2: torch.Tensor  # (N, F, D)
    bff2: torch.Tensor  # (N, D)
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor


# ------------------------------------------------------------------ #
# Random inputs: count matrices and dropout keep-masks
# ------------------------------------------------------------------ #


def count_matrices(index_sample: torch.Tensor, l_k: int) -> torch.Tensor:
    """``(..., L_q, U)`` sampled key indices -> ``(..., L_q, L_k)`` f32 counts
    (``cnt[q, k] = #{s : idx[q, s] = k}``, duplicates included)."""
    idx = index_sample.long()
    out = torch.zeros(*idx.shape[:-1], l_k, dtype=torch.float32, device=idx.device)
    return out.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.float32))


_eval_cnt_cache = {}  # (l_q, l_k, u_part, device) -> (L_q, L_k) counts


def sample_count_matrices(n_layers: int, l_q: int, l_k: int, u_part: int, *,
                          train: bool = False,
                          generator: Optional[torch.Generator] = None,
                          device=None) -> torch.Tensor:
    """Per-layer ProbSparse count matrices ``(N, L_q, L_k)`` f32.

    Eval (``train=False``): every layer uses the JAX package's fixed
    ``PRNGKey(0)`` draw, bit for bit (``utils/prng.py``). Train: fresh
    per-layer draws from ``generator`` (the device's default generator
    when None)."""
    device = torch.device("cpu" if device is None else device)
    if not train:
        key = (l_q, l_k, u_part, device)
        if key not in _eval_cnt_cache:
            idx = torch.from_numpy(
                prob_sparse_index_sample(l_q, u_part, l_k).astype(np.int64))
            cnt = count_matrices(idx, l_k).to(device)
            if torch.compiler.is_exporting():  # a graph value, never cached
                return cnt.expand(n_layers, l_q, l_k)
            _eval_cnt_cache[key] = cnt
        return _eval_cnt_cache[key].expand(n_layers, l_q, l_k)
    idx = torch.randint(0, l_k, (n_layers, l_q, u_part), generator=generator,
                        device=device)
    return count_matrices(idx, l_k)


def make_dropout_masks(n_layers, r, l, d, f, dropout_rate, *,
                       generator: Optional[torch.Generator] = None, device=None):
    """The three per-site int8 keep-masks ``(N, R, L, D)``, ``(N, R, L, F)``,
    ``(N, R, L, D)``: attention output, FFN activation, FFN output."""
    keep = 1.0 - dropout_rate

    def draw(width):
        u = torch.rand(n_layers, r, l, width, generator=generator, device=device)
        return (u < keep).to(torch.int8)

    return draw(d), draw(f), draw(d)


# ------------------------------------------------------------------ #
# Plain forward
# ------------------------------------------------------------------ #


def _mm(a: torch.Tensor, b: torch.Tensor, mm_dtype) -> torch.Tensor:
    """``a @ b`` with both operands rounded to ``mm_dtype``, f32 accumulation."""
    return a.to(mm_dtype).float() @ b.to(mm_dtype).float()


def ln_fwd(x, scale, bias):
    """f32 LayerNorm, nnx defaults: fast variance, eps 1e-6."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    xhat = (x - mu) * torch.rsqrt(var + _LN_EPS)
    return xhat * scale.float() + bias.float()


_ERF_ALPHA = (0.00022905065861350646, 0.0034082910107109506,
              0.050955695062380861, 0.18520832239976145, 1.128379143519084)
_ERF_BETA = (-1.1791602954361697e-7, 0.000023547966471313185,
             0.0010179625278914885, 0.014070470171167667,
             0.11098505178285362, 0.49746925110067538, 1.0)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_INV_SQRT_2PI = float(np.float32(1.0 / math.sqrt(2.0 * math.pi)))


def erf_f32(x):
    """XLA's rational f32 erf (x clamped to [-4, 4]), as the TPU kernel uses."""
    x = torch.clamp(x, -4.0, 4.0)
    x2 = x * x
    p = torch.full_like(x, _ERF_ALPHA[0])
    for a in _ERF_ALPHA[1:]:
        p = p * x2 + a
    q = torch.full_like(x, _ERF_BETA[0])
    for b in _ERF_BETA[1:]:
        q = q * x2 + b
    return x * p / q


def act_fwd(x, activation: str):
    if activation == "relu":
        return torch.clamp(x, min=0.0)
    return x * 0.5 * (1.0 + erf_f32(x / _SQRT2))


def act_grad(x, activation: str):
    if activation == "relu":
        return (x > 0.0).float()
    phi = torch.exp(-0.5 * x * x) * _INV_SQRT_2PI
    cdf = 0.5 * (1.0 + erf_f32(x / _SQRT2))
    return cdf + x * phi


def _heads(t, c, l, heads):  # (C*L, D) -> (C, H, L, Dh)
    return t.reshape(c, l, heads, -1).permute(0, 2, 1, 3)


def _merge(t):  # (C, H, L, Dh) -> (C*L, D)
    c, h, l, dh = t.shape
    return t.permute(0, 2, 1, 3).reshape(c * l, h * dh)


def attention_core(x, wq, bq, wk, bk, wv, bv, cnt, *, heads, u, mm_dtype):
    """Layer input ``(C, L, D)`` -> merged attention output ``(C*L, D)`` f32
    and ``(q, k, v, p, selected)`` per head for the backward."""
    c, l, d = x.shape
    scale = float(np.float32(1.0 / math.sqrt(d // heads)))
    xf = x.reshape(c * l, d)
    q = _heads(_mm(xf, wq, mm_dtype) + bq.float(), c, l, heads)
    k = _heads(_mm(xf, wk, mm_dtype) + bk.float(), c, l, heads)
    v = _heads(_mm(xf, wv, mm_dtype) + bv.float(), c, l, heads)
    qk = _mm(q, k.transpose(-1, -2), mm_dtype)  # (C, H, L, L) f32
    cnt = cnt.float()
    sampled_sum = (qk * cnt).sum(-1)
    sampled_max = torch.where(cnt > 0.0, qk, torch.full_like(qk, _NEG_INF)).amax(-1)
    m = sampled_max - sampled_sum / float(l)
    rank = (m[..., :, None] < m[..., None, :]).float().sum(-1)
    selected = (rank < float(u))[..., None]  # (C, H, L, 1)
    p = torch.softmax(qk * scale, dim=-1)
    upd = p @ v  # f32 x f32
    ctx = v.mean(2, keepdim=True)
    att = torch.where(selected, upd, ctx.expand_as(upd))
    return _merge(att), (q, k, v, p, selected)


def attention_core_tiled(x, wq, bq, wk, bk, wv, bv, cnt, *, heads, u, mm_dtype, tile=64):
    """K3a's attention algorithm in plain PyTorch: the measure's sampled
    sum and max accumulated over ``tile``-key tiles, the rank-test
    selection, then the f32 softmax and p.v (f32 x f32) for the selected
    queries only and the mean of V for the others. Returns the merged
    attention output ``(C*L, D)`` f32 and the selection ``(C, H, L)``."""
    c, l, d = x.shape
    scale = float(np.float32(1.0 / math.sqrt(d // heads)))
    xf = x.reshape(c * l, d)
    q = _heads(_mm(xf, wq, mm_dtype) + bq.float(), c, l, heads).to(mm_dtype).float()
    k = _heads(_mm(xf, wk, mm_dtype) + bk.float(), c, l, heads).to(mm_dtype).float()
    v = _heads(_mm(xf, wv, mm_dtype) + bv.float(), c, l, heads)
    cnt = cnt.float()
    sampled_sum = torch.zeros(q.shape[:-1], dtype=torch.float32, device=x.device)
    sampled_max = torch.full_like(sampled_sum, _NEG_INF)
    for j0 in range(0, l, tile):
        s = q @ k[..., j0:j0 + tile, :].transpose(-1, -2)  # (C, H, L, tile)
        ct = cnt[:, j0:j0 + tile]
        sampled_sum = sampled_sum + (s * ct).sum(-1)
        sampled_max = torch.maximum(
            sampled_max, torch.where(ct > 0.0, s, torch.full_like(s, _NEG_INF)).amax(-1))
    m = sampled_max - sampled_sum / float(l)
    selected = (m[..., :, None] < m[..., None, :]).sum(-1) < u  # (C, H, L)
    att = v.mean(2, keepdim=True).expand_as(v).clone()
    ci, hi, li = selected.nonzero(as_tuple=True)
    s = torch.einsum("se,sje->sj", q[ci, hi, li], k[ci, hi]) * scale
    att[ci, hi, li] = torch.einsum("sj,sje->se", torch.softmax(s, dim=-1), v[ci, hi])
    return _merge(att), selected


def _dropout(t, mask, keep):
    return t if mask is None else t * mask.float() * keep


def layer_forward(x, wl, cnt_l, masks_l, *, heads, u, dropout_rate, activation,
                  mm_dtype, internals=False, tiled=False):
    """One encoder layer (EncoderLayer semantics) on ``(C, L, D)`` f32.

    ``masks_l`` is None or three int8 keep-masks of this layer; with
    ``internals`` the recomputed intermediates are returned too; ``tiled``
    computes the attention as K3a does (``attention_core_tiled``; its
    internals then hold the selection ``(C, H, L)`` as ``saved``)."""
    (wq, bq, wk, bk, wv, bv, wout, bout, g1, b1,
     wff1, bff1, wff2, bff2, g2, b2) = wl
    c, l, d = x.shape
    keep = float(np.float32(1.0 / (1.0 - dropout_rate))) if dropout_rate else None
    m1, m2, m3 = masks_l if masks_l is not None else (None, None, None)
    x = x.float()
    core = attention_core_tiled if tiled else attention_core
    att, saved = core(x, wq, bq, wk, bk, wv, bv, cnt_l, heads=heads, u=u, mm_dtype=mm_dtype)
    new_x = (_mm(att, wout, mm_dtype) + bout.float()).reshape(c, l, d)
    x1 = x + _dropout(new_x, m1, keep)
    xn1 = ln_fwd(x1, g1, b1)
    f1 = _mm(xn1.reshape(c * l, d), wff1, mm_dtype) + bff1.float()
    a1 = _dropout(act_fwd(f1, activation),
                  None if m2 is None else m2.reshape(c * l, -1), keep)
    f2 = (_mm(a1, wff2, mm_dtype) + bff2.float()).reshape(c, l, d)
    z = xn1 + _dropout(f2, m3, keep)
    y = ln_fwd(z, g2, b2)
    if internals:
        return y, dict(att=att, saved=saved, x1=x1, xn1=xn1, f1=f1, a1=a1, z=z)
    return y


def _layer_masks(masks, i):
    return None if masks is None else tuple(m[i] for m in masks)


def _layer_weights(weights, i):
    return tuple(w[i] for w in weights)


def stack_reference(x, weights: StackWeights, cnt, masks, *, heads, u,
                    dropout_rate, activation="gelu", compute_bf16=True, tiled=False):
    """Plain forward: ``(R, L, D)`` -> ``(R, L, D)`` f32 through all N
    layers (``tiled``: K3a's attention algorithm)."""
    mm_dtype = torch.bfloat16 if compute_bf16 else torch.float32
    x = x.float()
    for i in range(weights.wq.shape[0]):
        x = layer_forward(x, _layer_weights(weights, i), cnt[i],
                          _layer_masks(masks, i), heads=heads, u=u,
                          dropout_rate=dropout_rate, activation=activation,
                          mm_dtype=mm_dtype, tiled=tiled)
    return x


# ------------------------------------------------------------------ #
# Plain backward (mirror of the JAX package's _layer_bwd)
# ------------------------------------------------------------------ #


def ln_bwd(x, scale, g):
    """Grad of ``ln_fwd``: ``(dx, g * xhat, g)`` with per-row weight grads."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    inv = torch.rsqrt(var + _LN_EPS)
    xhat = (x - mu) * inv
    gs = g * scale.float()
    m1 = gs.mean(-1, keepdim=True)
    m2 = (gs * xhat).mean(-1, keepdim=True)
    return (gs - m1 - xhat * m2) * inv, g * xhat, g


def layer_backward(x0, g, wl, cnt_l, masks_l, *, heads, u, dropout_rate,
                   activation, mm_dtype):
    """Backward of one layer from its input: ``(dx0, 16 weight grads)``."""
    (wq, bq, wk, bk, wv, bv, wout, bout, g1, b1,
     wff1, bff1, wff2, bff2, g2, b2) = wl
    c, l, d = x0.shape
    f = wff1.shape[-1]
    scale = float(np.float32(1.0 / math.sqrt(d // heads)))
    keep = float(np.float32(1.0 / (1.0 - dropout_rate))) if dropout_rate else None
    m1, m2, m3 = masks_l if masks_l is not None else (None, None, None)
    if m2 is not None:
        m2 = m2.reshape(c * l, f)
    _, it = layer_forward(x0, wl, cnt_l, masks_l, heads=heads, u=u,
                          dropout_rate=dropout_rate, activation=activation,
                          mm_dtype=mm_dtype, internals=True)
    att, (q, k, v, p, selected) = it["att"], it["saved"]
    xn1f = it["xn1"].reshape(c * l, d)

    dz, dg2_rows, db2_rows = ln_bwd(it["z"], g2, g.float())
    dg2 = dg2_rows.reshape(c * l, d).sum(0)
    db2 = db2_rows.reshape(c * l, d).sum(0)
    df2 = _dropout(dz, m3, keep).reshape(c * l, d)
    dbff2 = df2.sum(0)
    dwff2 = _mm(it["a1"].t(), df2, mm_dtype)  # (F, D)
    da1 = _dropout(_mm(df2, wff2.t(), mm_dtype), m2, keep)
    df1 = da1 * act_grad(it["f1"], activation)
    dbff1 = df1.sum(0)
    dwff1 = _mm(xn1f.t(), df1, mm_dtype)  # (D, F)
    dxn1 = dz + _mm(df1, wff1.t(), mm_dtype).reshape(c, l, d)

    dx1, dg1_rows, db1_rows = ln_bwd(it["x1"], g1, dxn1)
    dg1 = dg1_rows.reshape(c * l, d).sum(0)
    db1 = db1_rows.reshape(c * l, d).sum(0)
    dnew = _dropout(dx1, m1, keep).reshape(c * l, d)
    dbout = dnew.sum(0)
    dwout = _mm(att.t(), dnew, mm_dtype)
    datt = _heads(_mm(dnew, wout.t(), mm_dtype), c, l, heads)  # (C, H, L, Dh)

    g_upd = torch.where(selected, datt, torch.zeros_like(datt))
    g_ctx = torch.where(selected, torch.zeros_like(datt), datt)
    dv = p.transpose(-1, -2) @ g_upd + torch.full_like(p, 1.0 / float(l)) @ g_ctx
    dp = g_upd @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dqk = ds * scale
    dq = _merge(_mm(dqk, k, mm_dtype))
    dk = _merge(_mm(dqk.transpose(-1, -2), q, mm_dtype))
    dv = _merge(dv)
    x0f = x0.float().reshape(c * l, d)
    dx0 = dx1 + (_mm(dq, wq.t(), mm_dtype) + _mm(dk, wk.t(), mm_dtype)
                 + _mm(dv, wv.t(), mm_dtype)).reshape(c, l, d)
    grads = (_mm(x0f.t(), dq, mm_dtype), dq.sum(0),
             _mm(x0f.t(), dk, mm_dtype), dk.sum(0),
             _mm(x0f.t(), dv, mm_dtype), dv.sum(0),
             dwout, dbout, dg1, db1, dwff1, dbff1, dwff2, dbff2, dg2, db2)
    return dx0, grads


# ------------------------------------------------------------------ #
# The CUDA kernels (csrc/perceive_stack.cu)
# ------------------------------------------------------------------ #


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


SMEM_BYTES = 232448  # shared memory one H100 block can have
_SEL_THREADS, _SEL_WARPS = 128, 4  # K3a's select block (``perceive_stack.cu``)


def attn_smem_bytes(l: int, dh: int) -> int:
    """Shared memory of K3b's attention block (``perceive_stack.cu``
    ``attn_smem_bytes``): q, k, v, g, the L x L f32 score tile and the
    selection."""
    return 4 * (4 * l * (dh + 1) + l * (l + 1) + l)


@functools.lru_cache(maxsize=None)
def max_tokens(dh: int) -> int:
    """The largest L whose K3b attention block fits shared memory (208 at
    the d128 / 8-head width, below the DinoV2 frame encoder's 1370)."""
    l = 1
    while attn_smem_bytes(l + 1, dh) <= SMEM_BYTES:
        l += 1
    return l


def select_smem_bytes(l: int, dh: int) -> int:
    """Shared memory of K3a's select block (``perceive_stack.cu``
    ``select_smem_bytes``): the L measures, the selected queries and their
    flags, and the k and v tiles and the queries, which do not grow with L
    (head widths bucketed to 16, 32 or 64)."""
    bucket = 16 if dh <= 16 else 32 if dh <= 32 else 64
    tile = 4096 // bucket
    return 4 * (2 * l + _SEL_WARPS * 64 + (2 * tile * (bucket + 1) + tile * bucket)
                + _SEL_THREADS + 68) + l


def max_tokens_fwd(dh: int) -> int:
    """The largest L K3a takes: its rank test keeps the L measures in shared
    memory (19,937 tokens at 16-wide heads)."""
    fixed = select_smem_bytes(0, dh)
    return (SMEM_BYTES - fixed) // (select_smem_bytes(1, dh) - fixed)


def _check_width(x, heads):
    r, l, d = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the Perceive kernels take contiguous f32 (R, L, D) rows")
    if d % heads or d // heads > 64:
        raise ValueError(f"unsupported width D={d} with {heads} heads")
    if d % 8:
        raise ValueError(f"the Perceive kernels take D a multiple of 8, got D={d}")


def _check_fwd(x, weights, cnt, masks, heads, compute_bf16=False):
    """What K3a takes, checked once per stack call: f32 rows and weights on
    x's device, (N, L, L) counts, (N, R, L, D|F|D) masks, L within
    ``max_tokens_fwd``; with bf16 operands D = 128, one GEMM tile per row
    (the LayerNorm epilogue)."""
    r, l, d = x.shape
    n, f = weights.wff1.shape[0], weights.wff1.shape[-1]
    _check_width(x, heads)
    if compute_bf16 and d != 128:
        raise ValueError(f"the bf16 Perceive kernels take D = 128 (their LayerNorm runs in a "
                         f"GEMM epilogue over one 128-wide tile), got D={d}")
    if f % 8:
        raise ValueError(f"the Perceive kernels take F a multiple of 8, got F={f}")
    limit = max_tokens_fwd(d // heads)
    if l > limit:
        raise ValueError(f"K3a keeps the L measures of its rank test in shared memory and "
                         f"takes at most {limit} tokens at D={d} with {heads} heads, got L={l}")
    for w in weights:
        if w.dtype != torch.float32 or not w.is_contiguous() or w.device != x.device:
            raise ValueError("layer weights must be contiguous f32 on x's device")
        if w.shape[0] != n:
            raise ValueError("the stacked weights disagree on the number of layers")
    if (cnt.shape != (n, l, l) or cnt.dtype != torch.float32 or not cnt[0].is_contiguous()
            or cnt.device != x.device):
        raise ValueError(f"cnt must be f32 ({n}, {l}, {l}), each layer contiguous")
    if masks is not None:
        for m, width in zip(masks, (d, f, d)):
            if m.dtype != torch.int8 or m.shape != (n, r, l, width) or not m.is_contiguous():
                raise ValueError("masks must be contiguous int8 (N, R, L, D|F|D)")


def _check_bwd(x, heads):
    """K3b's token cap, checked before any launch."""
    l, d = x.shape[1], x.shape[2]
    limit = max_tokens(d // heads)
    if l > limit:
        raise ValueError(
            f"K3b (the Perceive stack's backward kernel) keeps an L x L score tile in "
            f"shared memory and takes at most {limit} tokens at D={d} with {heads} heads, "
            f"got L={l}: use the hybrid backward (ROUTEFORMER_FUSION_KERNEL=hybrid) or the "
            f"plain layers (0)")


class KernelWeights(NamedTuple):
    """What K3a/K3b read beside ``StackWeights``, derived from it."""

    wqkv: torch.Tensor  # (N, D, 3D) f32: wq | wk | wv
    bqkv: torch.Tensor  # (N, 3D) f32
    wqkv_t: torch.Tensor  # (N, 3D, D) bf16, (out, in)
    wout_t: torch.Tensor  # (N, D, D) bf16
    wff1_t: torch.Tensor  # (N, F, D) bf16
    wff2_t: torch.Tensor  # (N, D, F) bf16


def kernel_weights(weights) -> KernelWeights:
    """The kernels' derived weights from stacked (or one layer's) weights."""
    wq, bq, wk, bk, wv, bv, wout, _, _, _, wff1, _, wff2 = tuple(weights)[:13]

    def bf16_t(w):
        return w.transpose(-1, -2).to(torch.bfloat16).contiguous()

    with torch.no_grad():
        wqkv = torch.cat([wq, wk, wv], -1).float().contiguous()
        return KernelWeights(wqkv, torch.cat([bq, bk, bv], -1).float().contiguous(),
                             bf16_t(wqkv), bf16_t(wout), bf16_t(wff1), bf16_t(wff2))


SPLITS = 128  # about one split of a weight-gradient product per SM
LN_BLOCKS = 128  # ``perceive_stack.cu``: partial sums of the LayerNorm backward


def split_rows(m: int) -> int:
    """Rows per split of K3b's weight-gradient products (X^T dY over ``m``
    rows): a multiple of the GEMM core's 64-row k-step giving at most
    ``SPLITS`` splits."""
    return max(64, -(-(-(-m // SPLITS)) // 64) * 64)


def _align4(n: int) -> int:
    return -(-n // 4) * 4


def workspace_floats(m: int, d: int, f: int, heads: int, splits: int = 0) -> int:
    """f32 workspace of one K3a (``splits`` 0) or K3b layer call over ``m``
    rows: the forward's intermediates (with bf16 copies of the layer input
    and of xn1 for the GEMMs), the measures and the int8 selection,
    and for K3b the gradients, each split's partial products and column
    sums and the LayerNorm backward's partial sums (``perceive_stack.cu``
    ``carve``, which checks the size)."""
    fwd = m * (9 * d + 2 * f) + _align4(m * heads) + _align4(-(-m * heads // 4))
    if not splits:
        return fwd
    partials = splits * (4 * d * d + 2 * d * f + 5 * d + f)
    return fwd + m * (9 * d + f) + partials + 4 * LN_BLOCKS * d


_workspaces = {}  # device -> the f32 workspace, grown to the largest call


def _workspace(device, n: int) -> torch.Tensor:
    buf = _workspaces.get(device)
    if buf is None or buf.numel() < n:
        _workspaces.pop(device, None)  # free the smaller one first
        buf = _workspaces[device] = torch.empty(n, dtype=torch.float32, device=device)
    return buf


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def stack_forward_cuda(x, weights, kernel_w, cnt, masks, *, heads, u, dropout_rate,
                       activation, compute_bf16, keep_inputs=False, selection=None):
    """K3a: every layer of the stack over all rows in one call on the card.
    ``weights`` stacked (N, ...) f32, ``kernel_w`` their ``kernel_weights``,
    ``cnt`` (N, L, L) (a layer stride of 0 is kept), ``masks`` None or
    (N, R, L, D|F|D) int8. Returns ``y`` and, with ``keep_inputs``, each
    layer's input (N, R, L, D) (for K3b); ``selection``, if given, is an
    int8 (N, R, H, L) tensor that receives every layer's top-u picks."""
    global launches_fwd
    _check_fwd(x, weights, cnt, masks, heads, compute_bf16)
    r, l, d = x.shape
    n, f = weights.wff1.shape[0], weights.wff1.shape[-1]
    if selection is not None and (selection.dtype != torch.int8 or not selection.is_contiguous()
                                  or selection.shape != (n, r, heads, l)):
        raise ValueError("selection must be contiguous int8 (N, R, H, L)")
    lib = cuda_build.libraries()["perceive_stack"]
    y = torch.empty_like(x)
    xs = torch.empty(n, r, l, d, dtype=torch.float32, device=x.device) if keep_inputs else None
    size = workspace_floats(r * l, d, f, heads)
    ws = _workspace(x.device, size)
    keep = float(np.float32(1.0 / (1.0 - dropout_rate))) if masks is not None else 1.0
    m = masks if masks is not None else (None, None, None)
    err = lib.rf_perceive_stack_fwd(
        x.data_ptr(), y.data_ptr(), _ptr(xs), _ptr(selection), _pointers(weights),
        _pointers(kernel_w), cnt.data_ptr(), cnt.stride(0), *map(_ptr, m), ctypes.c_float(keep),
        n, r, l, d, f, heads, u, _ACT[activation], int(compute_bf16), ws.data_ptr(), ws.numel(),
        _stream(x))
    cuda_build.check(err, "perceive_stack_fwd")
    launches_fwd += n
    return (y, xs) if keep_inputs else y


@torch.library.custom_op("routeformer::perceive_stack", mutates_args=(), device_types="cpu")
def perceive_stack(x: torch.Tensor, weights: List[torch.Tensor],
                   kernel_w: List[torch.Tensor], cnt: torch.Tensor,
                   masks: List[torch.Tensor], heads: int, u: int,
                   dropout_rate: float, activation: str, compute_bf16: bool,
                   keep_inputs: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3a as a registered op: the N-layer stack forward on contiguous f32
    ``(R, L, D)`` rows with ``weights`` (``StackWeights`` order, f32),
    ``kernel_w`` (``KernelWeights``; derived from ``weights`` when empty),
    ``cnt`` (N, L, L) and ``masks`` empty or three int8 ``(N, R, L,
    D|F|D)``. Returns ``(y, inputs)``: ``inputs`` is each layer's input
    ``(N, R, L, D)`` with ``keep_inputs``, else empty. The CPU runs the
    plain layers (``kernel_w`` unread), the card ``stack_forward_cuda``."""
    w = StackWeights(*weights)
    mm = torch.bfloat16 if compute_bf16 else torch.float32
    inputs = []
    for i in range(w.wq.shape[0]):
        inputs.append(x)
        x = layer_forward(x, _layer_weights(w, i), cnt[i], _layer_masks(masks or None, i),
                          heads=heads, u=u, dropout_rate=dropout_rate,
                          activation=activation, mm_dtype=mm)
    return x, torch.stack(inputs) if keep_inputs else x.new_empty(0)


@perceive_stack.register_kernel("cuda")
def _perceive_stack_cuda(x, weights, kernel_w, cnt, masks, heads, u, dropout_rate,
                         activation, compute_bf16, keep_inputs):
    w = StackWeights(*weights)
    kw = KernelWeights(*kernel_w) if kernel_w else kernel_weights(w)
    out = stack_forward_cuda(x, w, kw, cnt, tuple(masks) or None,
                             heads=heads, u=u, dropout_rate=dropout_rate,
                             activation=activation, compute_bf16=compute_bf16,
                             keep_inputs=keep_inputs)
    return out if keep_inputs else (out, x.new_empty(0))


@perceive_stack.register_fake
def _perceive_stack_fake(x, weights, kernel_w, cnt, masks, heads, u, dropout_rate,
                         activation, compute_bf16, keep_inputs):
    n = weights[0].shape[0]
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty((n, *x.shape) if keep_inputs else (0,)))


def _one_layer(wl, cnt_l, masks_l):
    """A layer's weights, counts and masks as a stack of one."""
    return (StackWeights(*(w[None] for w in wl)), cnt_l[None],
            None if masks_l is None else tuple(m[None] for m in masks_l))


def layer_forward_cuda(x, wl, cnt_l, masks_l, *, heads, u, dropout_rate,
                       activation, compute_bf16, selection=None, kernel_w=None):
    """K3a on one layer: ``stack_forward_cuda`` over a stack of one.
    ``selection``, if given, is an int8 ``(R, H, L)`` tensor that receives
    the top-u picks."""
    weights, cnt, masks = _one_layer(wl, cnt_l, masks_l)
    kernel_w = kernel_weights(weights) if kernel_w is None else kernel_w
    return stack_forward_cuda(
        x, weights, kernel_w, cnt, masks, heads=heads, u=u, dropout_rate=dropout_rate,
        activation=activation, compute_bf16=compute_bf16,
        selection=None if selection is None else selection[None])


def layer_backward_cuda(x0, g, wl, cnt_l, masks_l, *, heads, u, dropout_rate,
                        activation, compute_bf16, selection=None, kernel_w=None):
    """K3b: one layer backward from its saved input on the card. ``wl``
    and ``kernel_w`` (``kernel_weights`` of the layer; derived when None)
    carry no layer axis; ``selection``, if given, is an int8 ``(R, H, L)``
    tensor that receives the selection the recompute made and the backward
    differentiated."""
    global launches_bwd
    weights, cnt, masks = _one_layer(wl, cnt_l, masks_l)
    _check_fwd(x0, weights, cnt, masks, heads, compute_bf16)
    _check_bwd(x0, heads)
    r, l, d = x0.shape
    if g.shape != x0.shape or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("g must be contiguous f32 shaped like x")
    if selection is not None and (selection.dtype != torch.int8 or not selection.is_contiguous()
                                  or selection.shape != (r, heads, l)):
        raise ValueError("selection must be contiguous int8 (R, H, L)")
    kernel_w = kernel_weights(wl) if kernel_w is None else kernel_w
    lib = cuda_build.libraries()["perceive_stack"]
    dx = torch.empty_like(x0)
    flat = torch.empty(sum(w.numel() for w in wl), dtype=torch.float32, device=x0.device)
    grads = [t.view(w.shape) for t, w in zip(flat.split([w.numel() for w in wl]), wl)]
    m = r * l
    rows = split_rows(m)
    ws = _workspace(x0.device, workspace_floats(m, d, wl[10].shape[-1], heads, -(-m // rows)))
    keep = float(np.float32(1.0 / (1.0 - dropout_rate))) if masks_l is not None else 1.0
    mk = masks_l if masks_l is not None else (None, None, None)
    err = lib.rf_perceive_layer_bwd(
        x0.data_ptr(), g.data_ptr(), dx.data_ptr(), _ptr(selection), _pointers(wl),
        _pointers(kernel_w), _pointers(grads), cnt_l.data_ptr(), *map(_ptr, mk),
        ctypes.c_float(keep), r, l, d, wl[10].shape[-1], heads, u, _ACT[activation],
        int(compute_bf16), rows, ws.data_ptr(), ws.numel(), _stream(x0))
    cuda_build.check(err, "perceive_layer_bwd")
    launches_bwd += 1
    return dx, tuple(grads)


def gemm_core_plain(a, b, *, bias=None, act=None, mask=None, keep=1.0, aux=None,
                    aux_act=None, res=None, compute_bf16=True):
    """Plain version of ``gemm_core``: ``(c, pre)`` with the operands
    rounded to bf16 (``compute_bf16``), f32 accumulation, then the layer's
    epilogue in its order."""
    v = _mm(a, b, torch.bfloat16 if compute_bf16 else torch.float32)
    if bias is not None:
        v = v + bias
    pre = v
    if act is not None:
        v = act_fwd(v, act)
    if mask is not None:
        v = v * mask.float() * keep
    if aux is not None:
        v = v * act_grad(aux, aux_act)
    if res is not None:
        v = res + v
    return v, pre


def gemm_core(a, b, *, a_t=False, b_t=False, bias=None, act=None, mask=None, keep=1.0,
              aux=None, aux_act=None, res=None, with_pre=False, split=None,
              compute_bf16=True):
    """The Perceive layers' GEMM on its own, on the card: ``c = epilogue(A
    B)`` for f32 ``a`` (M, K) (``a_t``: ``a`` holds A^T, (K, M)) and ``b``
    (K, N) (``b_t``: ``b`` holds B^T, (N, K)), each with unit stride along
    its last dimension, through the GEMM core (``compute_bf16``) or the f32
    FMA path. Returns ``c``, with ``with_pre`` also the pre-activation, and
    with ``split`` (rows per split of K, a multiple of 64) the product split
    over K as the weight grads are, reduced in order, and B's column sums:
    ``(c, colsum)``, no epilogue."""
    m, k = (a.shape[1], a.shape[0]) if a_t else a.shape
    n = b.shape[0] if b_t else b.shape[1]
    lib = cuda_build.libraries()["perceive_stack"]
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    pre = torch.empty_like(c) if with_pre else None
    colsum = torch.empty(n, dtype=torch.float32, device=a.device) if split else None
    ws = (torch.empty(-(-k // split) * (m * n + n), dtype=torch.float32, device=a.device)
          if split else None)
    # A(i, j) = a[i sa + j sa'] and B(i, j) = b[i sb + j sb'] in elements
    sa = (1, a.stride(0)) if a_t else (a.stride(0), 1)
    sb = (1, b.stride(0)) if b_t else (b.stride(0), 1)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.rf_perceive_gemm(
        a.data_ptr(), *sa, b.data_ptr(), *sb, c.data_ptr(), m, n, k, ptr(bias), ptr(pre), _ACT.get(act, 0), ptr(mask),
        ctypes.c_float(keep), ptr(aux), _ACT.get(aux_act, 0), ptr(res), split or 0,
        ptr(ws), ptr(colsum), int(compute_bf16), _stream(a))
    cuda_build.check(err, "perceive_gemm")
    if split:
        return c, colsum
    return (c, pre) if with_pre else c


# ------------------------------------------------------------------ #
# Autograd wiring
# ------------------------------------------------------------------ #


def _run_layer_bwd(x0, g, wl, cnt_l, masks_l, cfg, kernel_w):
    heads, u, p, act, bf16 = cfg
    if x0.device.type == "cpu":
        return layer_backward(x0, g, wl, cnt_l, masks_l, heads=heads, u=u,
                              dropout_rate=p, activation=act,
                              mm_dtype=torch.bfloat16 if bf16 else torch.float32)
    return layer_backward_cuda(x0, g, wl, cnt_l, masks_l, heads=heads, u=u,
                               dropout_rate=p, activation=act, compute_bf16=bf16,
                               kernel_w=kernel_w)


def _hybrid_layer_bwd(x0, g, wl, cnt_l, masks_l, cfg, kernel_w):
    """Autograd over the plain layer forward (the hybrid backward)."""
    heads, u, p, act, bf16 = cfg
    with torch.enable_grad():
        xs = x0.detach().requires_grad_(True)
        ws = [w.detach().requires_grad_(True) for w in wl]
        y = layer_forward(xs, ws, cnt_l, masks_l, heads=heads, u=u,
                          dropout_rate=p, activation=act,
                          mm_dtype=torch.bfloat16 if bf16 else torch.float32)
        out = torch.autograd.grad(y, [xs, *ws], g)
    return out[0], tuple(out[1:])


class _FusedStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg, backward, cnt, masks, kernel_w, x, *weights):
        heads, u, p, act, bf16 = cfg
        weights = StackWeights(*(w.detach().float().contiguous() for w in weights))
        x = x.detach().float().contiguous()
        keep = any(ctx.needs_input_grad)
        if x.device.type != "cpu":
            if keep and backward == "kernel":
                _check_bwd(x, heads)  # before any launch
            kernel_w = kernel_weights(weights) if kernel_w is None else kernel_w
        x, inputs = perceive_stack(x, list(weights), list(kernel_w or ()), cnt,
                                   list(masks or ()), heads, u, p, act, bf16, keep)
        if keep:
            ctx.cfg, ctx.backward, ctx.cnt, ctx.masks = cfg, backward, cnt, masks
            ctx.inputs, ctx.weights, ctx.kernel_w = inputs, weights, kernel_w
        return x

    @staticmethod
    def backward(ctx, g):
        run = _hybrid_layer_bwd if ctx.backward == "hybrid" else _run_layer_bwd
        g = g.float().contiguous()
        n_layers = len(ctx.inputs)
        per_layer = [None] * n_layers
        for i in range(n_layers - 1, -1, -1):
            kw = None if ctx.kernel_w is None else KernelWeights(*(t[i] for t in ctx.kernel_w))
            g, per_layer[i] = run(ctx.inputs[i], g, _layer_weights(ctx.weights, i),
                                  ctx.cnt[i].contiguous(), _layer_masks(ctx.masks, i),
                                  ctx.cfg, kw)
        dws = [torch.stack([per_layer[i][j] for i in range(n_layers)])
               for j in range(len(ctx.weights))]
        return (None, None, None, None, None, g, *dws)


def prob_sparse_u(l: int, factor: int) -> int:
    return min(int(factor * math.ceil(math.log(l))), l)


def fused_perceive_stack(
    x: torch.Tensor,
    weights: StackWeights,
    cnt: torch.Tensor,
    masks: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    *,
    heads: int,
    factor: int = 5,
    dropout_rate: float = 0.0,
    activation: str = "gelu",
    compute_bf16: bool = True,
    backward: str = "kernel",
    kernel_w: Optional[KernelWeights] = None,
) -> torch.Tensor:
    """The N-layer ProbSparse encoder stack, differentiable in x and weights.

    ``x`` ``(R, L, D)``; ``cnt`` ``(N, L, L)`` (``sample_count_matrices``);
    ``masks`` None or three int8 keep-masks ``(N, R, L, D|F|D)``;
    ``backward`` "kernel" (K3b per layer) or "hybrid" (autograd over the
    plain layer forward); ``kernel_w`` the kernels' derived weights
    (``kernel_weights(weights)``, derived per call when None; the CPU path
    reads none). Returns ``(R, L, D)`` f32.
    """
    if backward not in ("kernel", "hybrid"):
        raise ValueError(f"backward must be 'kernel' or 'hybrid', got {backward!r}")
    if activation not in _ACT:
        raise ValueError(f"unknown activation {activation!r}")
    u = prob_sparse_u(x.shape[1], factor)
    train = masks is not None and dropout_rate > 0.0
    cfg = (heads, u, float(dropout_rate) if train else 0.0, activation,
           bool(compute_bf16))
    return _FusedStack.apply(cfg, backward, cnt.float(),
                             tuple(masks) if train else None, kernel_w, x, *weights)
