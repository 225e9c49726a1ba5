"""The attention kernels of ``routeformer_tpu/ops/flash_attention.py``:

- K2, SwinV2 window attention (``flash_window_attention``, kernel
  ``_flash_window_kernel``), kernel ``csrc/window_attention.cu``;
  ``launches`` counts its launches.
- K4, dense softmax attention (``flash_attention_bhle``, kernel
  ``_flash_kernel``), kernel ``csrc/dense_attention.cu``;
  ``dense_launches`` counts its launches.

Both are softmax attention with f32 scores that never leave the chip, and
both keep S, P and the output accumulator in registers on the tensor cores
(the shared helpers are ``csrc/attention_frag.cuh``). K4 does 684 FLOP per
byte at the DinoV2 shape, so operations bound it: q·kᵀ on ``wgmma``, an
online softmax on the accumulator registers, and p·v as two register-A
``wgmma`` products (p = p_hi + p_lo in bf16, so p keeps f32 precision as on
the TPU), K and V streaming through a two-stage shared-memory ring. K2 does
128 FLOP per byte at n = 256, d = 32, so bytes bound it: ``mma.sync`` with
``ldmatrix``, K and V of a (window, head) loaded and normalised once per
CTA with 16-byte loads, each warp holding the scores of all keys of its 16
rows in registers, so that P is normalised in f32 before its bf16 rounding
as the TPU does. Each kernel's header gives the arithmetic and where it
still falls short of its bound.

Each kernel is a registered op, so that ``torch.export`` traces the
serving forward through it (a fake tensor has no ``data_ptr`` for a ctypes
launch): ``routeformer::window_attention`` (K2) and
``routeformer::dense_attention`` (K4), whose CUDA implementation launches
the kernel and whose CPU implementation is the plain version; their fake
implementations give the output's layout (``_window_out``,
``_dense_out``). The autograd Functions call the ops for CUDA tensors (K4
for CPU ones too) and differentiate through autograd over an f32
recompute of the plain version, as the JAX custom VJPs do; the plain
versions (``*_plain``) are callable on any device. K4 reads (batch, head,
token) strided views in place (``dense_attention_blhe`` takes the ViT's
``(B, L, H, E)`` views of its qkv rows and writes ``(B, L, H, E_v)``); it
copies an operand only when E is not a multiple of 8 (zero-padding it) or a
bf16 row does not start on a 16-byte boundary.
"""

import ctypes

import torch
import torch.nn.functional as F

from routeformer_torch.ops import cuda_build

launches = 0
dense_launches = 0
DENSE_MAX_E = 128  # widest E and E_v K4 takes
_NEG_INF = -1e30


def _normalise(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=1e-12))


def flash_window_attention_plain(q, k, v, bias, scale=None, cosine=False):
    """Plain version: ``(B, H, N, d)`` q/k/v, ``bias`` ``(NB, H, N, N)``.

    Matmul operands are rounded to bf16 when ``v`` is bf16 (f32 otherwise)
    with f32 accumulation, as the TPU kernel does; the output has v's dtype.
    """
    b, h, n, d = q.shape
    nb = bias.shape[0]
    mm = torch.bfloat16 if v.dtype == torch.bfloat16 else torch.float32
    qf, kf = q.float(), k.float()
    if cosine:
        qf, kf = _normalise(qf), _normalise(kf)
    s = qf.to(mm).float() @ kf.to(mm).float().transpose(-1, -2)
    if cosine:
        s = s * scale.float().reshape(1, h, 1, 1)
    s = (s.reshape(b // nb, nb, h, n, n) + bias.float()[None]).reshape(b, h, n, n)
    p = torch.softmax(s, dim=-1)
    out = p.to(mm).float() @ v.to(mm).float()
    return out.to(v.dtype)


def launch_window_attention(q, k, v, q_strides, bias, scale, out, out_strides,
                            batch, heads, n, d, cosine):
    """Launch the kernel on raw views; q/k/v (bf16 or f32) share
    ``q_strides`` ``(batch, head, token)`` in elements, unit stride along d;
    ``out`` is bf16. Every row of q, k, v and out must start on a 16-byte
    boundary."""
    global launches
    if not (_rows16((q, k, v), q_strides) and _rows16((out,), out_strides)):
        raise ValueError("window kernel: q, k, v and out rows must start on 16-byte boundaries")
    lib = cuda_build.libraries()["window_attention"]
    err = lib.rf_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        int(q.dtype == torch.bfloat16), *q_strides,
        bias.data_ptr(), bias.shape[0], scale.data_ptr(),
        out.data_ptr(), *out_strides, batch, heads, n, d, int(cosine),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    cuda_build.check(err, "window_attention")
    launches += 1


def _rows16(tensors, strides) -> bool:
    """Every row of each of ``tensors`` (one dtype, element strides
    ``strides``) starts on a 16-byte boundary."""
    per16 = 16 // tensors[0].element_size()
    return all(t.data_ptr() % 16 == 0 for t in tensors) and all(s % per16 == 0 for s in strides)


def _check_window(q, k, v, bias, scale):
    """What K2 takes: q, k, v of one shape, dtype (bf16 or f32) and device,
    unit stride along d, d in (16, 32, 64), n <= 256; a contiguous f32
    ``(NB, H, N, N)`` bias with B % NB == 0; a contiguous f32 ``(H,)``
    scale."""
    b, h, n, d = q.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"the window kernel reads q, k, v all bf16 or all f32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in (16, 32, 64) or not 1 <= n <= 256:
        raise ValueError(f"window kernel supports d in (16, 32, 64) and n <= 256, "
                         f"got d={d}, n={n}")
    for t in (q, k, v):
        if t.shape != q.shape or t.stride(-1) != 1 or t.device != q.device:
            raise ValueError("q, k, v must share shape and device, unit stride on d")
    if (bias.dtype != torch.float32 or not bias.is_contiguous()
            or bias.shape[1:] != (h, n, n) or b % bias.shape[0]):
        raise ValueError(f"bias must be contiguous f32 (NB, H, N, N) with "
                         f"B % NB == 0, got {tuple(bias.shape)}")
    if scale.dtype != torch.float32 or scale.numel() != h or not scale.is_contiguous():
        raise ValueError("scale must be contiguous f32 (H,)")


def _window_out(q: torch.Tensor, heads_inner: bool) -> torch.Tensor:
    """K2's bf16 output ``(B, H, N, d)``; with ``heads_inner`` its memory is
    ``(B, N, H, d)``, the rows K1's block tail reads."""
    b, h, n, d = q.shape
    if heads_inner:
        return torch.empty(b, n, h, d, dtype=torch.bfloat16, device=q.device).transpose(1, 2)
    return torch.empty(b, h, n, d, dtype=torch.bfloat16, device=q.device)


@torch.library.custom_op("routeformer::window_attention", mutates_args=(), device_types="cpu")
def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     scale: torch.Tensor, cosine: bool, heads_inner: bool) -> torch.Tensor:
    """K2 as a registered op: ``(B, H, N, d)`` q, k, v (bf16 or f32, any
    (batch, head, token) strides) attended with bf16 operands and f32
    scores, written bf16 as ``_window_out`` lays it out. The CPU runs the
    plain version, the card the kernel."""
    out = _window_out(q, heads_inner)
    out.copy_(flash_window_attention_plain(q, k, v.to(torch.bfloat16), bias, scale, cosine))
    return out


@window_attention.register_kernel("cuda")
def _window_attention_cuda(q, k, v, bias, scale, cosine, heads_inner):
    _check_window(q, k, v, bias, scale)
    b, h, n, d = q.shape
    sb, sh, sn, _ = q.stride()
    if (k.stride() != q.stride() or v.stride() != q.stride()
            or not _rows16((q, k, v), (sb, sh, sn))):
        # Fresh contiguous copies: rows of d in (16, 32, 64) from the
        # allocator start on 16-byte boundaries.
        q, k, v = (t.clone(memory_format=torch.contiguous_format) for t in (q, k, v))
        sb, sh, sn, _ = q.stride()
    out = _window_out(q, heads_inner)
    launch_window_attention(q, k, v, (sb, sh, sn), bias, scale, out, out.stride()[:3],
                            b, h, n, d, cosine)
    return out


@window_attention.register_fake
def _window_attention_fake(q, k, v, bias, scale, cosine, heads_inner):
    return _window_out(q, heads_inner)


class _WindowAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA, through the ``window_attention`` op) or
    the plain version (CPU, in v's dtype). Backward:
    autograd over a recompute of the plain version in f32, cast to v's
    dtype, as the JAX package's custom VJP differentiates
    ``_reference_window_attention``."""

    @staticmethod
    def forward(ctx, cosine, q, k, v, bias, scale):
        ctx.cosine = cosine
        ctx.save_for_backward(q, k, v, bias, scale)
        if q.device.type == "cpu":
            return flash_window_attention_plain(q, k, v, bias, scale, cosine)
        if v.dtype != torch.bfloat16 or q.dtype != v.dtype or k.dtype != v.dtype:
            raise TypeError(
                "the CUDA window kernel computes with bf16 operands and writes "
                f"bf16: pass bf16 q/k/v (got {q.dtype}, {k.dtype}, {v.dtype})"
            )
        return window_attention(q, k, v, bias, scale, cosine, False)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            q, k, v, bias, scale = inputs
            out = flash_window_attention_plain(q.float(), k.float(), v.float(),
                                               bias, scale, ctx.cosine).to(v.dtype)
            grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
        return (None, *grads)


def flash_window_attention(q, k, v, bias, scale=None, cosine=False):
    """Biased multi-head window attention on ``(B, H, N, d)`` tensors,
    differentiable in q, k, v, the bias and the scale.

    Batch row ``b`` uses ``bias[b % NB]``; ``cosine`` L2-normalises q and k
    and multiplies the scores by the per-head ``scale`` ``(H,)``.
    """
    if scale is None:
        scale = torch.ones(q.shape[1], dtype=torch.float32, device=q.device)
    return _WindowAttention.apply(cosine, q, k, v, bias, scale)


# ----------------------------------------------------------------- K4 --- #


def attention_bhle_plain(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """Plain version (``_reference_attention_bhle``): f32 scores, keys with
    col > row set to -1e30 when ``causal``, f32 softmax and p·v, output in
    q's dtype. Any leading dimensions: ``(..., L, E)``."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        l_q, l_k = q.shape[-2], k.shape[-2]
        upper = torch.ones(l_q, l_k, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(upper, _NEG_INF)
    return (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)


def _check_dense(q, k, v):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K4 takes q, k, v all bf16 or all f32, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not q.ndim == k.ndim == v.ndim == 4:
        raise ValueError("K4 takes (BH, L, E) or (B, H, L, E) tensors")
    b, h, l_q, e = q.shape
    if (k.shape[:2] != (b, h) or v.shape[:2] != (b, h) or k.shape[3] != e
            or v.shape[2] != k.shape[2]):
        raise ValueError(f"K4 shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if e > DENSE_MAX_E or v.shape[3] > DENSE_MAX_E:
        raise ValueError(f"K4 takes E and E_v up to {DENSE_MAX_E}, got {e}, {v.shape[3]}")
    if not (1 <= b <= 65535 and 1 <= h <= 65535) or l_q < 1 or k.shape[2] < 1:
        raise ValueError(f"K4 takes 1 <= B, H <= 65535 and non-empty L, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")


def _dense_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` as K4 reads it in place: unit stride along E and, in bf16, E a
    multiple of 8 and every row on a 16-byte boundary. Otherwise a
    contiguous copy, with E zero-padded to a multiple of 8 in bf16."""
    if t.dtype == torch.float32:
        return t if t.stride(-1) == 1 else t.contiguous()
    if t.stride(-1) == 1 and t.shape[-1] % 8 == 0 and _rows16((t,), t.stride()[:-1]):
        return t
    return F.pad(t, (0, -t.shape[-1] % 8)).contiguous()


def _dense_out(q: torch.Tensor, v: torch.Tensor, heads_inner: bool) -> torch.Tensor:
    """K4's output ``(B, H, L_q, E_v)`` in q's dtype, whose memory is
    ``(B, L_q, H, E_v')`` with ``heads_inner`` (else ``(B, H, L_q,
    E_v')``): E_v' is E_v padded to a multiple of 8 in bf16 (as
    ``_dense_operand`` pads v), cut back to E_v as a view."""
    b, h, l_q, _ = q.shape
    e_v = v.shape[-1]
    e_vp = e_v + (-e_v % 8 if q.dtype == torch.bfloat16 else 0)
    if heads_inner:
        out = torch.empty(b, l_q, h, e_vp, dtype=q.dtype, device=q.device).transpose(1, 2)
    else:
        out = torch.empty(b, h, l_q, e_vp, dtype=q.dtype, device=q.device)
    return out[..., :e_v]


def launch_dense_attention(q, k, v, causal: bool, scale: float,
                           heads_inner: bool = False) -> torch.Tensor:
    """K4 on CUDA ``(B, H, L, E)`` tensors of any (batch, head, token)
    strides, on the current stream: returns ``_dense_out``. An operand is
    copied only as ``_dense_operand`` says."""
    global dense_launches
    _check_dense(q, k, v)
    b, h, l_q, _ = q.shape
    l_k = v.shape[2]
    qp, kp, vp = _dense_operand(q), _dense_operand(k), _dense_operand(v)
    out = _dense_out(q, v, heads_inner)
    lib = cuda_build.libraries()["dense_attention"]
    err = lib.rf_dense_attention(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), b, h, l_q, l_k, qp.shape[-1], vp.shape[-1],
        *qp.stride()[:3], *kp.stride()[:3], *vp.stride()[:3], *out.stride()[:3],
        ctypes.c_float(scale), int(causal),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    cuda_build.check(err, "dense_attention")
    dense_launches += 1
    return out


@torch.library.custom_op("routeformer::dense_attention", mutates_args=(), device_types="cpu")
def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                    scale: float, heads_inner: bool) -> torch.Tensor:
    """K4 as a registered op on ``(B, H, L, E)`` tensors of any strides
    (``v`` ``(B, H, L_k, E_v)``): f32 scores and softmax, the output laid
    out as ``_dense_out`` says. The CPU runs the plain version, the card
    the kernel."""
    out = _dense_out(q, v, heads_inner)
    out.copy_(attention_bhle_plain(q, k, v, causal, scale))
    return out


@dense_attention.register_kernel("cuda")
def _dense_attention_cuda(q, k, v, causal, scale, heads_inner):
    return launch_dense_attention(q, k, v, causal, scale, heads_inner)


@dense_attention.register_fake
def _dense_attention_fake(q, k, v, causal, scale, heads_inner):
    return _dense_out(q, v, heads_inner)


class _DenseAttention(torch.autograd.Function):
    """Forward: the ``dense_attention`` op (K4 on the card, the plain
    version on the CPU) on ``(BH, L, E)`` or ``(B, H, L, E)`` tensors; with
    ``heads_inner`` the output lives in ``(B, L_q, H, E_v)`` memory.
    Backward: autograd over a recompute of the plain version in f32, cast
    to q's dtype, as the JAX package's custom VJP differentiates
    ``_reference_attention_bhle``."""

    @staticmethod
    def forward(ctx, causal, scale, heads_inner, q, k, v):
        if not q.device == k.device == v.device:
            raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v)
        if q.ndim == 3:  # (BH, L, E): one batch row of BH heads
            return dense_attention(q[None], k[None], v[None], causal, scale, False)[0]
        return dense_attention(q, k, v, causal, scale, heads_inner)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            q, k, v = inputs
            out = attention_bhle_plain(q.float(), k.float(), v.float(), ctx.causal,
                                       ctx.scale).to(q.dtype)
            grads = torch.autograd.grad(out, inputs, g)
        return (None, None, None, *grads)


def flash_attention_bhle(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """Dense softmax attention on head-flattened ``(BH, L, E)`` tensors
    (``v`` ``(BH, L_k, E_v)``), differentiable in q, k and v."""
    return _DenseAttention.apply(bool(causal), float(scale), False, q, k, v)


def dense_attention_blhe(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """Dense softmax attention on ``(B, L, H, E)`` tensors of any strides
    (``v`` ``(B, L_k, H, E_v)``), differentiable in q, k and v. On the card
    K4 reads the views in place and writes ``(B, L_q, H, E_v)`` memory."""
    out = _DenseAttention.apply(bool(causal), float(scale), True, q.transpose(1, 2),
                                k.transpose(1, 2), v.transpose(1, 2))
    return out.transpose(1, 2)
