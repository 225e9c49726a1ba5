"""K2: SwinV2 window attention (counterpart of
``routeformer_tpu/ops/flash_attention.py::flash_window_attention``).

The kernel is ``csrc/window_attention.cu`` (its header says what bounds it
on the H100 and what the design does about it). ``flash_window_attention``
runs it for CUDA tensors and the plain PyTorch version for CPU tensors,
and differentiates through autograd over an f32 recompute of the plain
version; ``flash_window_attention_plain`` is that plain version, callable
on any device. ``launches`` counts kernel launches.
"""

import ctypes

import torch

from routeformer_torch.ops import cuda_build

launches = 0


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
    """Launch the kernel on raw views; q/k/v share ``q_strides``
    ``(batch, head, token)`` in elements, unit stride along d."""
    global launches
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


def _check_cuda(q, k, v, bias, scale):
    b, h, n, d = q.shape
    if v.dtype != torch.bfloat16 or q.dtype != v.dtype or k.dtype != v.dtype:
        raise TypeError(
            "the CUDA window kernel computes with bf16 operands and writes "
            f"bf16: pass bf16 q/k/v (got {q.dtype}, {k.dtype}, {v.dtype})"
        )
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


class _WindowAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    autograd over a recompute of the plain version in f32, cast to v's
    dtype, as the JAX package's custom VJP differentiates
    ``_reference_window_attention``."""

    @staticmethod
    def forward(ctx, cosine, q, k, v, bias, scale):
        ctx.cosine = cosine
        ctx.save_for_backward(q, k, v, bias, scale)
        if q.device.type == "cpu":
            return flash_window_attention_plain(q, k, v, bias, scale, cosine)
        _check_cuda(q, k, v, bias, scale)
        b, h, n, d = q.shape
        out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
        sb, sh, sn, _ = q.stride()
        if k.stride() != q.stride() or v.stride() != q.stride():
            k, v, q = k.contiguous(), v.contiguous(), q.contiguous()
            sb, sh, sn, _ = q.stride()
        launch_window_attention(q, k, v, (sb, sh, sn), bias, scale, out,
                                out.stride()[:3], b, h, n, d, cosine)
        return out

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
