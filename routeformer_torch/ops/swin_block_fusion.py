"""K1: the fused SwinV2 block (counterpart of
``routeformer_tpu/ops/swin_block_fusion.py::fused_swin_block_forward``).

On Hopper the block is a pipeline of hand-written kernels over all windows
at once (``csrc/swin_block.cu`` explains why and what bounds it): qkv GEMM,
window attention (K2), proj GEMM, ``x + LN1``, fc1 GEMM with the gelu
(``gelu``: the tanh gelu, or the exact one through ``erff``), fc2 GEMM,
``x + LN2``. Its three C calls are registered ops
(``routeformer::gemm_bias_act``, K2's ``routeformer::window_attention``,
``routeformer::swin_block_tail``), so ``torch.export`` traces the block:
on the card each launches its kernel, on the CPU it runs its plain piece,
which rounds where the kernel does (together, bit for bit
``fused_swin_block_plain``). ``fused_swin_block`` runs the block through
them; its gradient is autograd over a recompute of the f32 plain version.
``launches`` counts pipeline launches (one per block call, in the tail),
``launches_erf`` those of them with the exact gelu. Its four GEMMs run on
the Hopper GEMM core (``csrc/gemm_sm90.cuh``, TMA producer), and
``derived`` keeps what the block derives from its parameters (the bf16
weights, the qkv bias, the exponentiated logit scale, the position bias)
from one call to the next.

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
launches_erf = 0
LN_EPS = 1e-5
# The GEMM epilogue's ``act``: none, the tanh gelu, the exact (erf) gelu.
ACT_NONE, ACT_TANH, ACT_ERF = 0, 1, 2
GELU_ACT = {"tanh": ACT_TANH, "exact": ACT_ERF}


def tanh_gelu(x: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def erf_gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def _act(v: torch.Tensor, act: int) -> torch.Tensor:
    return tanh_gelu(v) if act == ACT_TANH else erf_gelu(v) if act == ACT_ERF else v


def _ln(x, scale, bias, eps=LN_EPS):
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


def fused_swin_block_plain(x_windows, params, bias, n_heads, compute_bf16=True, gelu="tanh"):
    """Plain version of the block on ``(B, n, C)`` window rows.

    With ``compute_bf16`` every matmul operand is rounded to bf16 (f32
    accumulation) at the TPU kernel's rounding points; with False it is the
    f32 ``swin_block_reference``. ``gelu``: "tanh" or "exact" (erf).
    Returns ``x_windows``' dtype.
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
    y = _act(linear(x, params["wfc1"], params["bfc1"]), GELU_ACT[gelu])
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
    none, 1 tanh gelu, 2 exact gelu (``ACT_*``). Launches on the current
    stream."""
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
    return _act(v, act).to(out_dtype)


@torch.library.custom_op("routeformer::gemm_bias_act", mutates_args=(), device_types="cpu")
def gemm_bias_act_op(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, act: int,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """K1's first C call as a registered op: ``act(a w^T + bias)`` (M, N)
    in ``out_dtype``. The CPU runs ``gemm_bias_act_plain``, the card the
    GEMM core."""
    return gemm_bias_act_plain(a, w, bias, act, out_dtype)


@gemm_bias_act_op.register_kernel("cuda")
def _gemm_bias_act_cuda(a, w, bias, act, out_dtype):
    if (a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or bias.dtype != torch.float32
            or not (a.is_contiguous() and w.is_contiguous() and bias.is_contiguous())
            or a.shape[1] != w.shape[1] or a.shape[1] % 8 or bias.shape != (w.shape[0],)):
        raise ValueError(f"gemm_bias_act takes contiguous bf16 a (M, K), w (N, K) with K a "
                         f"multiple of 8 and f32 bias (N,); got {tuple(a.shape)} {a.dtype}, "
                         f"{tuple(w.shape)} {w.dtype}, {tuple(bias.shape)} {bias.dtype}")
    out = torch.empty(a.shape[0], w.shape[0], dtype=out_dtype, device=a.device)
    return gemm_bias_act(a, w, bias, out, act)


@gemm_bias_act_op.register_fake
def _gemm_bias_act_fake(a, w, bias, act, out_dtype):
    return a.new_empty(a.shape[0], w.shape[0], dtype=out_dtype)


TAIL_KEYS = ("wproj", "bproj", "ln1_scale", "ln1_bias", "wfc1", "bfc1", "wfc2", "bfc2",
             "ln2_scale", "ln2_bias")


def swin_block_tail_plain(x, attn, wproj, bproj, ln1_scale, ln1_bias, wfc1, bfc1, wfc2,
                          bfc2, ln2_scale, ln2_bias, act=ACT_TANH):
    """Plain version of the block's tail on ``(M, C)`` rows: ``x1 = x +
    LN1(attn wproj^T + bproj)``, ``x1 + LN2(fc2(gelu(fc1(x1))))`` (``act``:
    the tanh or the erf gelu), the matmul operands rounded to bf16 (f32
    accumulation), in x's dtype."""

    def linear(t, w, bb):
        return t.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().transpose(0, 1) \
            + bb.float()

    x1 = x.float() + _ln(linear(attn, wproj, bproj), ln1_scale, ln1_bias)
    y = linear(_act(linear(x1, wfc1, bfc1), act), wfc2, bfc2)
    return (x1 + _ln(y, ln2_scale, ln2_bias)).to(x.dtype)


@torch.library.custom_op("routeformer::swin_block_tail", mutates_args=(), device_types="cpu")
def swin_block_tail(x: torch.Tensor, attn: torch.Tensor, wproj: torch.Tensor,
                    bproj: torch.Tensor, ln1_scale: torch.Tensor, ln1_bias: torch.Tensor,
                    wfc1: torch.Tensor, bfc1: torch.Tensor, wfc2: torch.Tensor,
                    bfc2: torch.Tensor, ln2_scale: torch.Tensor,
                    ln2_bias: torch.Tensor, act: int = ACT_TANH) -> torch.Tensor:
    """K1's last C call as a registered op: proj, ``x + LN1``, fc1 with
    the gelu ``act`` (``ACT_TANH`` or ``ACT_ERF``), fc2, ``x + LN2`` on
    ``(M, C)`` rows (x bf16 or f32, attn bf16, the three weights bf16
    ``(out, in)``, the rest f32), in x's dtype. The CPU runs
    ``swin_block_tail_plain``, the card ``rf_swin_block_tail``;
    ``launches`` counts it, one a block, ``launches_erf`` the erf ones."""
    return swin_block_tail_plain(x, attn, wproj, bproj, ln1_scale, ln1_bias, wfc1, bfc1,
                                 wfc2, bfc2, ln2_scale, ln2_bias, act)


@swin_block_tail.register_kernel("cuda")
def _swin_block_tail_cuda(x, attn, wproj, bproj, ln1_scale, ln1_bias, wfc1, bfc1, wfc2,
                          bfc2, ln2_scale, ln2_bias, act=ACT_TANH):
    global launches, launches_erf
    m, c = x.shape
    if (x.dtype not in (torch.bfloat16, torch.float32) or attn.dtype != torch.bfloat16
            or attn.shape != (m, c) or c % 8 or act not in (ACT_TANH, ACT_ERF)
            or any(t.dtype != torch.bfloat16 for t in (wproj, wfc1, wfc2))):
        raise ValueError("swin_block_tail takes (M, C) x (bf16 or f32) and attn (bf16), "
                         "C a multiple of 8, bf16 wproj, wfc1, wfc2, act 1 or 2")
    lib = cuda_build.libraries()["swin_block"]
    x, attn, wproj, wfc1, wfc2 = (t.contiguous() for t in (x, attn, wproj, wfc1, wfc2))
    p = [_f32(t) for t in (bproj, ln1_scale, ln1_bias, bfc1, bfc2, ln2_scale, ln2_bias)]
    out = torch.empty_like(x)
    # The tail's a, x1, x1 in bf16, y (bf16), y2 (rf_swin_block_tail).
    ws = torch.empty(11 * m * c // 2, dtype=torch.float32, device=x.device)
    err = lib.rf_swin_block_tail(
        x.data_ptr(), int(x.dtype == torch.bfloat16), attn.data_ptr(),
        wproj.data_ptr(), p[0].data_ptr(), p[1].data_ptr(), p[2].data_ptr(),
        wfc1.data_ptr(), p[3].data_ptr(), wfc2.data_ptr(), p[4].data_ptr(),
        p[5].data_ptr(), p[6].data_ptr(), out.data_ptr(), int(out.dtype == torch.bfloat16),
        ws.data_ptr(), m, c, LN_EPS, act,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream),
    )
    cuda_build.check(err, "swin_block_tail")
    launches += 1
    if act == ACT_ERF:
        launches_erf += 1
    return out


@swin_block_tail.register_fake
def _swin_block_tail_fake(x, *_):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _fused_swin_block_ops(x_windows, params, bias, n_heads, gelu="tanh"):
    """The block as K1's three registered ops: the qkv GEMM, K2 on views of
    its f32 rows (written into ``(B, n, H, d)`` memory), the tail. On the
    card these are the kernels; on the CPU their plain versions, which
    round where the kernels do."""
    b, n, c = x_windows.shape
    h = n_heads
    if x_windows.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x_windows must be bf16 or f32, got {x_windows.dtype}")
    if c % h:
        raise ValueError(f"unsupported block geometry n={n}, C={c}, heads={h}")
    bias = bias.float()
    if bias.ndim == 3:
        bias = bias[None]
    bias = bias.contiguous()
    if bias.shape[1:] != (h, n, n) or b % bias.shape[0]:
        raise ValueError(f"bias {tuple(bias.shape)} does not fit ({b}, {h}, {n}, {n})")
    m = b * n
    x = x_windows.reshape(m, c).contiguous()
    wqkv, wproj, wfc1, wfc2 = _bf16_weights(params)
    qkv = gemm_bias_act_op(x.to(torch.bfloat16), wqkv, _f32(params["bqkv"]), ACT_NONE,
                           torch.float32)
    # q, k, v are views of the qkv rows: (window, head, token) strides.
    q, k, v = qkv.view(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4).unbind(0)
    attn = flash_attention.window_attention(q, k, v, bias, _f32(params["logit_scale"]),
                                            True, True)
    tail = dict(params, wproj=wproj, wfc1=wfc1, wfc2=wfc2)
    out = swin_block_tail(x, attn.transpose(1, 2).reshape(m, c),
                          *(tail[key] for key in TAIL_KEYS), GELU_ACT[gelu])
    return out.reshape(b, n, c)


PARAM_KEYS = ("wqkv", "bqkv", "wproj", "bproj", "ln1_scale", "ln1_bias", "wfc1",
              "bfc1", "wfc2", "bfc2", "ln2_scale", "ln2_bias", "logit_scale")


class _FusedBlock(torch.autograd.Function):
    """Forward: K1's three registered ops (``_fused_swin_block_ops``).
    Backward: autograd over a recompute of the f32 plain version, as the
    JAX package's custom VJP differentiates ``swin_block_reference``."""

    @staticmethod
    def forward(ctx, n_heads, compute_bf16, gelu, x_windows, bias, *params):
        ctx.n_heads, ctx.gelu = n_heads, gelu
        ctx.save_for_backward(x_windows, bias, *params)
        p = dict(zip(PARAM_KEYS, params))
        if not compute_bf16:  # the f32 reference, CPU only
            return fused_swin_block_plain(x_windows, p, bias, n_heads, compute_bf16, gelu)
        return _fused_swin_block_ops(x_windows, p, bias, n_heads, gelu)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            y = fused_swin_block_plain(inputs[0], dict(zip(PARAM_KEYS, inputs[2:])),
                                       inputs[1], ctx.n_heads, compute_bf16=False,
                                       gelu=ctx.gelu)
            grads = torch.autograd.grad(y, inputs, g, allow_unused=True)
        return (None, None, None, *grads)


def fused_swin_block(x_windows, params, bias, n_heads, compute_bf16=True, gelu="tanh"):
    """One SwinV2 block (attention + MLP, res-post-norm) on window rows,
    differentiable in the rows, the bias and every parameter; ``gelu``
    "tanh" or "exact" (erf)."""
    if x_windows.device.type != "cpu" and not compute_bf16:
        raise ValueError(
            "the CUDA fused block computes with bf16 operands; "
            "compute_bf16=False runs only on the CPU"
        )
    if gelu not in GELU_ACT:
        raise ValueError(f"gelu must be one of {sorted(GELU_ACT)}, got {gelu!r}")
    return _FusedBlock.apply(n_heads, compute_bf16, gelu, x_windows, bias,
                             *(params[k] for k in PARAM_KEYS))


def fused_swin_block_forward(x_windows, params, *, n_heads, bias, compute_bf16=True):
    """K1's forward without autograd (the JAX package's name and keywords):
    on the card the kernel's three ops, on the CPU their plain versions;
    ``compute_bf16=False`` is the f32 ``swin_block_reference`` (CPU only).
    ``params`` as ``fused_swin_block`` takes them: the port's weights,
    ``(out, in)`` like ``nn.Linear``, where the JAX package's are ``(in,
    out)``."""
    with torch.no_grad():
        return fused_swin_block(x_windows, params, bias, n_heads, compute_bf16)


def swin_block_reference(x_windows, params, *, n_heads, bias):
    """The plain f32 block on window rows (the JAX package's executable spec
    of K1), differentiable: ``fused_swin_block_plain`` without the bf16
    rounding points."""
    return fused_swin_block_plain(x_windows, params, bias, n_heads, compute_bf16=False)
