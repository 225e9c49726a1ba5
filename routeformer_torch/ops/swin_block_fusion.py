"""K1: the fused SwinV2 block (counterpart of
``routeformer_tpu/ops/swin_block_fusion.py::fused_swin_block_forward``).

On Hopper the block is a pipeline of hand-written kernels over all windows
at once (``csrc/swin_block.cu`` explains why and what bounds it): qkv GEMM,
window attention (K2), proj GEMM, ``x + LN1``, fc1 GEMM with tanh gelu,
fc2 GEMM, ``x + LN2``. ``fused_swin_block`` runs it for CUDA tensors and
the plain PyTorch version for CPU tensors; its gradient is autograd over
a recompute of the f32 plain version. ``launches`` counts pipeline
launches (one per block call). Its four GEMMs run on the Hopper GEMM core
(``csrc/gemm_sm90.cuh``, TMA producer), and ``derived`` keeps what the
block derives from its parameters (the bf16 weights, the qkv bias, the
exponentiated logit scale, the position bias) from one call to the next.

``params`` holds the block's weights in torch layout (``(out, in)``):
``wqkv (3C, C)``, ``bqkv (3C,)``, ``wproj (C, C)``, ``bproj``,
``ln1_scale``, ``ln1_bias``, ``wfc1 (4C, C)``, ``bfc1``, ``wfc2 (C, 4C)``,
``bfc2``, ``ln2_scale``, ``ln2_bias`` and ``logit_scale (H,)``, already
clamped and exponentiated. ``bias`` is ``(H, n, n)`` shared by every
window, or ``(nW, H, n, n)`` per window kind with the window index varying
fastest along the batch.
"""

import ctypes
import math

import torch

from routeformer_torch.ops import cuda_build, flash_attention
from routeformer_torch.ops.weight_cache import derived

launches = 0
LN_EPS = 1e-5


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def _ln(x, scale, bias, eps=LN_EPS):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


def fused_swin_block_plain(x_windows, params, bias, n_heads, compute_bf16=True):
    """Plain version of the block on ``(B, n, C)`` window rows.

    With ``compute_bf16`` every matmul operand is rounded to bf16 (f32
    accumulation) at the TPU kernel's rounding points; with False it is the
    f32 ``swin_block_reference``. Returns ``x_windows``' dtype.
    """
    b, n, c = x_windows.shape
    h = n_heads
    mm = torch.bfloat16 if compute_bf16 else torch.float32

    def rnd(t):
        return t.to(mm).float()

    def linear(t, w, bb):
        return rnd(t) @ rnd(w).transpose(0, 1) + bb.float()

    x = x_windows.float()
    qkv = linear(x, params["wqkv"], params["bqkv"])
    qkv = qkv.reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
    q, k, v = flash_attention._normalise(qkv[0]), flash_attention._normalise(qkv[1]), qkv[2]
    s = rnd(q) @ rnd(k).transpose(-1, -2)
    s = s * params["logit_scale"].float().reshape(1, h, 1, 1)
    bias = bias.float()
    if bias.ndim == 3:
        bias = bias[None]
    nb = bias.shape[0]
    s = (s.reshape(b // nb, nb, h, n, n) + bias[None]).reshape(b, h, n, n)
    p = torch.softmax(s, dim=-1)
    attn = (rnd(p) @ rnd(v)).transpose(1, 2).reshape(b, n, c)
    a = linear(attn, params["wproj"], params["bproj"])
    x = x + _ln(a, params["ln1_scale"], params["ln1_bias"])
    y = tanh_gelu(linear(x, params["wfc1"], params["bfc1"]))
    y = linear(y, params["wfc2"], params["bfc2"])
    x = x + _ln(y, params["ln2_scale"], params["ln2_bias"])
    return x.to(x_windows.dtype)


def _f32(t):
    return t.float().contiguous()


def _bf16_weights(params):
    """The kernel's bf16 copies of the four weight matrices, cached
    (``derived``)."""
    return derived("bf16", lambda *w: tuple(t.to(torch.bfloat16).contiguous() for t in w),
                   *(params[k] for k in ("wqkv", "wproj", "wfc1", "wfc2")),
                   differentiable=False)


def gemm_bias_act(a, w, bias, out, act=0):
    """K1's GEMM on the Hopper GEMM core (TMA producer): ``out = act(a w^T
    + bias)`` for bf16 ``a`` (M, K) and ``w`` (N, K), contiguous, K a
    multiple of 8; f32 ``bias`` (N,); ``out`` (M, N) f32 or bf16; act 0
    none, 1 tanh gelu. Launches on the current stream."""
    lib = cuda_build.libraries()["swin_block"]
    err = lib.rf_gemm_bias_act(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        int(out.dtype == torch.bfloat16), a.shape[0], w.shape[0], w.shape[1], act,
        ctypes.c_void_p(torch.cuda.current_stream(a.device).cuda_stream),
    )
    cuda_build.check(err, "gemm_bias_act")
    return out


def gemm_bias_act_plain(a, w, bias, act=0, out_dtype=torch.float32):
    """Plain version of ``gemm_bias_act`` (bf16 products are exact in f32)."""
    v = a.float() @ w.float().transpose(0, 1) + bias.float()
    return (tanh_gelu(v) if act else v).to(out_dtype)


def _fused_swin_block_cuda(x_windows, params, bias, n_heads):
    global launches
    b, n, c = x_windows.shape
    h = n_heads
    d = c // h
    dev = x_windows.device
    if x_windows.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x_windows must be bf16 or f32, got {x_windows.dtype}")
    if c % h or c % 8 or d not in (16, 32, 64) or not 1 <= n <= 256:
        raise ValueError(f"unsupported block geometry n={n}, C={c}, heads={h}")
    bias = bias.float()
    if bias.ndim == 3:
        bias = bias[None]
    bias = bias.contiguous()
    if bias.shape[1:] != (h, n, n) or b % bias.shape[0]:
        raise ValueError(f"bias {tuple(bias.shape)} does not fit ({b}, {h}, {n}, {n})")
    lib = cuda_build.libraries()["swin_block"]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    m = b * n
    x = x_windows.reshape(m, c).contiguous()
    wqkv, wproj, wfc1, wfc2 = _bf16_weights(params)
    # One workspace: qkv (f32), attn (bf16), then the tail's a, x1, x1 in
    # bf16, y (bf16), y2 (rf_swin_block_tail).
    mc = m * c
    ws = torch.empty(9 * mc, dtype=torch.float32, device=dev)
    qkv = ws[:3 * mc].view(m, 3 * c)
    attn = ws[3 * mc:7 * mc // 2].view(torch.bfloat16).view(m, c)
    gemm_bias_act(x.to(torch.bfloat16), wqkv, _f32(params["bqkv"]), qkv)
    # q, k, v are views of the qkv rows: (window, head, token) strides.
    flash_attention.launch_window_attention(
        qkv, qkv[:, c:], qkv[:, 2 * c:], (n * 3 * c, d, 3 * c), bias,
        _f32(params["logit_scale"]), attn, (n * c, d, c), b, h, n, d, True,
    )
    out = torch.empty(m, c, dtype=x_windows.dtype, device=dev)
    p = {k: _f32(params[k]) for k in ("bproj", "ln1_scale", "ln1_bias", "bfc1", "bfc2",
                                      "ln2_scale", "ln2_bias")}
    err = lib.rf_swin_block_tail(
        x.data_ptr(), int(x.dtype == torch.bfloat16), attn.data_ptr(),
        wproj.data_ptr(), p["bproj"].data_ptr(), p["ln1_scale"].data_ptr(),
        p["ln1_bias"].data_ptr(), wfc1.data_ptr(), p["bfc1"].data_ptr(), wfc2.data_ptr(),
        p["bfc2"].data_ptr(), p["ln2_scale"].data_ptr(), p["ln2_bias"].data_ptr(),
        out.data_ptr(), int(out.dtype == torch.bfloat16), ws[7 * mc // 2:].data_ptr(),
        m, c, LN_EPS, stream,
    )
    cuda_build.check(err, "swin_block_tail")
    launches += 1
    return out.reshape(b, n, c)


PARAM_KEYS = ("wqkv", "bqkv", "wproj", "bproj", "ln1_scale", "ln1_bias", "wfc1",
              "bfc1", "wfc2", "bfc2", "ln2_scale", "ln2_bias", "logit_scale")


class _FusedBlock(torch.autograd.Function):
    """Forward: the kernel pipeline (CUDA) or the plain version (CPU).
    Backward: autograd over a recompute of the f32 plain version, as the
    JAX package's custom VJP differentiates ``swin_block_reference``."""

    @staticmethod
    def forward(ctx, n_heads, compute_bf16, x_windows, bias, *params):
        ctx.n_heads = n_heads
        ctx.save_for_backward(x_windows, bias, *params)
        p = dict(zip(PARAM_KEYS, params))
        if x_windows.device.type == "cpu":
            return fused_swin_block_plain(x_windows, p, bias, n_heads, compute_bf16)
        return _fused_swin_block_cuda(x_windows, p, bias, n_heads)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            y = fused_swin_block_plain(inputs[0], dict(zip(PARAM_KEYS, inputs[2:])),
                                       inputs[1], ctx.n_heads, compute_bf16=False)
            grads = torch.autograd.grad(y, inputs, g, allow_unused=True)
        return (None, None, *grads)


def fused_swin_block(x_windows, params, bias, n_heads, compute_bf16=True):
    """One SwinV2 block (attention + MLP, res-post-norm) on window rows,
    differentiable in the rows, the bias and every parameter."""
    if x_windows.device.type != "cpu" and not compute_bf16:
        raise ValueError(
            "the CUDA fused block computes with bf16 operands; "
            "compute_bf16=False runs only on the CPU"
        )
    return _FusedBlock.apply(n_heads, compute_bf16, x_windows, bias,
                             *(params[k] for k in PARAM_KEYS))
