"""Attention functions on ``(B, L, H, E)`` tensors (counterpart of
``routeformer_tpu/ops/attention.py``).

- ``dot_product_attention``: dense softmax attention. With the JAX
  package's rule (``_use_flash``: ``L_k >= 512``, no dropout, no weights)
  it takes the fused route, K4 (``ops/flash_attention.py``); otherwise the
  plain einsum path. The fused route is ``dense_attention_blhe`` on both
  devices: on the card K4 reads the strided ``(B, L, H, E)`` views (the
  ViT's views of its qkv rows) in place and writes ``(B, L, H, E_v)``; on
  the CPU its plain version runs on the same views. Only the DinoV2 ViT at
  518 px (1369 tokens) reaches the fused route.
- ``prob_sparse_attention``: Informer's ProbSparse attention in the JAX
  package's default "masked" formulation: dense scores and softmax for all
  queries, and each row keeps the dense output when its sparsity measure
  is at least the ``u``-th largest, else the mean of V (non-causal) or the
  running sum of V (causal).
- ``autocorrelation_attention``: Autoformer's FFT AutoCorrelation
  (``torch.fft``, f32), its top-k delays taken by a stable descending
  sort, so that tied correlations pick the lower delay first as
  ``jax.lax.top_k`` does.

Rounding follows the JAX code: scores of bf16 inputs accumulate in f32
(``preferred_element_type``) for ProbSparse; the dense path rounds its
scores to the input dtype before the f32 softmax, as ``jnp.einsum`` does.
"""

import math
import os
from typing import Optional

import numpy as np
import torch

from routeformer_torch.ops.flash_attention import dense_attention_blhe
from routeformer_torch.utils.prng import prob_sparse_index_sample

_NEG_INF = -1e30
_index_cache = {}  # (l_q, u_part, l_k, device) -> the eval key sample


def _causal_mask(l_q: int, l_k: int, device) -> torch.Tensor:
    return torch.ones(l_q, l_k, dtype=torch.bool, device=device).triu(1)


def _use_flash(q, k, dropout_rate, deterministic, need_weights) -> bool:
    """The JAX package's dispatch rule for the fused kernel.
    ``ROUTEFORMER_FLASH``: ``0`` never, ``1`` always, ``auto`` (default)
    when ``L_k >= 512``; never with dropout in force or weights asked for.
    JAX also requires a TPU backend; here the rule decides the route, and
    the tensors' device decides kernel or plain version."""
    if need_weights or (dropout_rate > 0.0 and not deterministic):
        return False
    mode = os.environ.get("ROUTEFORMER_FLASH", "auto")
    if mode == "0":
        return False
    if mode == "1":
        return True
    return k.shape[1] >= 512


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    impl: str = "auto",
    need_weights: bool = False,
):
    """Dense softmax attention on ``(B, L, H, E)``; scale defaults to
    ``1/sqrt(E)``. With ``dropout_rate`` the attention weights are dropped
    (training; callers pass 0 in eval). ``impl``: ``auto`` (the rule of
    ``_use_flash``), ``flash`` (K4) or ``plain``. With ``need_weights``
    it returns ``(out, weights)``, the f32 softmax weights before dropout
    (the plain path). The JAX package's additive bias, which keeps its
    plain path, has no caller here."""
    if impl not in ("auto", "flash", "plain"):
        raise ValueError(f"impl must be 'auto', 'flash' or 'plain', got {impl!r}")
    l_q, e, l_k = q.shape[1], q.shape[3], k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(e)
    if impl == "flash" or (
        impl == "auto"
        and _use_flash(q, k, dropout_rate, deterministic=False, need_weights=need_weights)
    ):
        # K4 (its plain version on the CPU) on the (B, L, H, E) views.
        return dense_attention_blhe(q, k, v, causal, scale)
    scores = torch.einsum("blhe,bshe->bhls", q, k).float()
    if causal:
        scores = scores.masked_fill(_causal_mask(l_q, l_k, q.device), _NEG_INF)
    weights = torch.softmax(scores * scale, dim=-1)
    dropped = weights
    if dropout_rate > 0.0:
        dropped = torch.nn.functional.dropout(weights, dropout_rate)
    out = torch.einsum("bhls,bshd->blhd", dropped.to(v.dtype), v)
    return (out, weights) if need_weights else out


def prob_sparse_sizes(l_q: int, l_k: int, factor: int):
    """``(u, u_part)``: selected queries and sampled keys per query."""
    u_part = min(int(factor * math.ceil(math.log(l_k))), l_k)
    u = min(int(factor * math.ceil(math.log(l_q))), l_q)
    return u, u_part


def prob_sparse_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    factor: int = 5,
    causal: bool = False,
    scale: Optional[float] = None,
    index_sample=None,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """ProbSparse attention; returns f32 ``(B, L_q, H, D)``.

    ``index_sample`` ``(L_q, U_part)`` picks the sampled keys. When it is
    None and ``train``, it is drawn from ``generator`` (the device's default
    generator when None); otherwise the eval draw of the JAX package
    (``randint(PRNGKey(0), ...)``) is used.
    """
    b, l_q, h, e = q.shape
    l_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(e)
    u, u_part = prob_sparse_sizes(l_q, l_k, factor)
    if index_sample is None:
        if train:
            index_sample = torch.randint(
                0, l_k, (l_q, u_part), generator=generator, device=q.device,
            )
        else:
            key = (l_q, u_part, l_k, q.device)
            index_sample = _index_cache.get(key)
            if index_sample is None:  # one host-to-device copy per shape
                index_sample = torch.from_numpy(
                    prob_sparse_index_sample(l_q, u_part, l_k).astype(np.int64)
                ).to(q.device)
                if not torch.compiler.is_exporting():  # a graph value, never cached
                    _index_cache[key] = index_sample
    if isinstance(index_sample, np.ndarray):
        index_sample = torch.from_numpy(index_sample.astype(np.int64))
    index_sample = index_sample.to(device=q.device, dtype=torch.long)

    qt, kt = q.float().transpose(1, 2), k.float().transpose(1, 2)
    vt = v.transpose(1, 2)  # (B, H, L, D)
    qk = qt @ kt.transpose(-1, -2)  # (B, H, L_q, L_k) f32
    sample = torch.gather(
        qk, 3, index_sample.expand(b, h, l_q, u_part)
    )  # (B, H, L_q, U_part)
    m = sample.amax(-1) - sample.sum(-1) / l_k
    thresh = torch.topk(m, u, dim=-1).values[..., -1:]
    selected = m >= thresh

    scores = qk * scale
    vf = vt.float()
    if causal:
        scores = scores.masked_fill(_causal_mask(l_q, l_k, q.device), _NEG_INF)
        context = vf.cumsum(2).to(v.dtype).float()  # requires L_q == L_k
    else:
        context = vf.mean(2, keepdim=True).to(v.dtype).float().expand(
            b, h, l_q, vf.shape[-1]
        )
    update = torch.softmax(scores, dim=-1) @ vf
    out = torch.where(selected[..., None], update, context)
    return out.transpose(1, 2)


def autocorrelation_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    factor: int = 1,
    training: bool = True,
    data_group=None,
):
    """Autoformer AutoCorrelation on ``(B, L, H, E)`` tensors; returns
    ``(out (B, L, H, E) in v's dtype, corr (B, L, H, E) f32)``.

    Keys and values are cut or zero-padded to the query length; the
    per-(head, channel) circular cross-correlation
    ``irfft(rfft(q) * conj(rfft(k)))`` runs over time in f32; the top
    ``int(factor * ln L)`` delays are softmax-weighted and V is aggregated
    by circularly shifting it by each delay. In training the delays come
    from the batch mean of the correlation (shared by every row: on a mesh
    with several data shards, ``data_group``, the global batch's mean);
    in eval each row takes its own. Ties go to the lower delay."""
    b, l, h, e = q.shape
    s = k.shape[1]
    if l > s:
        pad = v.new_zeros(b, l - s, h, v.shape[-1])
        v = torch.cat([v, pad], dim=1)
        k = torch.cat([k, pad.to(k.dtype)], dim=1)
    else:
        v, k = v[:, :l], k[:, :l]
    qt = q.permute(0, 2, 3, 1).float()  # (B, H, E, L)
    kt = k.permute(0, 2, 3, 1).float()
    vt = v.permute(0, 2, 3, 1).float()
    corr = torch.fft.irfft(torch.fft.rfft(qt, dim=-1) * torch.conj(torch.fft.rfft(kt, dim=-1)),
                           n=l, dim=-1)
    top_k = int(factor * math.log(l))
    mean_value = corr.mean(dim=(1, 2))  # (B, L)
    positions = torch.arange(l, device=q.device)
    if training:
        batch_mean = mean_value.mean(dim=0)
        if data_group is not None:
            import torch.distributed as dist

            total = torch.cat([mean_value.detach().sum(dim=0),
                               mean_value.new_full((1,), float(b))])
            dist.all_reduce(total, group=data_group)
            batch_mean = total[:-1] / total[-1]
        delay = _top_indices(batch_mean, top_k)  # (k,)
        weights = mean_value[:, delay]  # (B, k)
        idx = (positions[None, :] + delay[:, None]) % l  # (k, L)
        patterns = vt[..., idx]  # (B, H, E, k, L)
    else:
        delay = _top_indices(mean_value, top_k)  # (B, k)
        weights = torch.gather(mean_value, 1, delay)
        idx = (positions[None, None, :] + delay[:, :, None]) % l  # (B, k, L)
        patterns = torch.gather(
            vt[:, :, :, None, :].expand(b, h, vt.shape[2], top_k, l), 4,
            idx[:, None, None].expand(b, h, vt.shape[2], top_k, l))
    out = torch.einsum("bhekl,bk->bhel", patterns, torch.softmax(weights, dim=-1))
    return out.permute(0, 3, 1, 2).to(v.dtype), corr.permute(0, 3, 1, 2)


def _top_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest entries along the last dim, larger
    first and the lower index first among equals (``jax.lax.top_k``'s
    order; ``torch.topk`` promises none on CUDA)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
