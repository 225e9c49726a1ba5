"""The CUDA kernels K1, K2, K3a, K3b and K4, and the Hopper GEMM core that
K1 and K3 share, against their plain versions on a card.

Marked ``cuda``: without a card every test skips. The file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from routeformer_torch.ops import attention, flash_attention, fusion_stack, swin_block_fusion


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, *shape, s=1.0):
    return torch.randn(*shape, generator=gen) * s


def _max_err(got, want):
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


# The GEMMs of one SwinV2 block, (M, N, K, act, out dtype) per stage at batch
# 1 (M = windows x tokens): qkv, proj, fc1 (tanh gelu), fc2; then ragged M,
# N and K.
K1_GEMMS = [(m, n, k, act, dt) for m, c in ((98304, 128), (24576, 256), (6144, 512),
                                            (1536, 1024))
            for n, k, act, dt in ((3 * c, c, 0, "float32"), (c, c, 0, "float32"),
                                  (4 * c, c, 1, "bfloat16"), (c, 4 * c, 0, "float32"))]
K1_GEMMS += [(1000, 200, 72, 1, "bfloat16"), (77, 130, 136, 0, "float32"),
             (1000, 520, 72, 0, "float32")]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,act,dtype", K1_GEMMS)
def test_gemm_core_tma_matches_matmul(cuda_device, m, n, k, act, dtype):
    """The core with its TMA producer (K1's bf16 operands) against
    ``torch.matmul`` of the same bf16 values in f32 (exact products): f32
    output within 1e-4 of its max (sums in another order), bf16 within 1e-2
    (one rounding of the output)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(m + n + k)
    a = _randn(g, m, k).to(cuda_device, torch.bfloat16)
    w = _randn(g, n, k, s=k ** -0.5).to(cuda_device, torch.bfloat16)
    bias = _randn(g, n, s=0.1).to(cuda_device)
    out = torch.empty(m, n, dtype=getattr(torch, dtype), device=cuda_device)
    got = swin_block_fusion.gemm_bias_act(a, w, bias, out, act)
    want = swin_block_fusion.gemm_bias_act_plain(a, w, bias, act, torch.float32)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= (1e-2 if dtype == "bfloat16" else 1e-4)


# The Perceive layers' GEMMs (M rows, D 128, F 256): X W, dY W^T and the
# weight grads X^T dY split over the rows, at the frame, video and gaze
# stacks' M; then ragged shapes. (M, N, K, a_t, b_t, split).
K3_GEMMS = [g for m in (24960, 2560, 640) for g in (
    (m, 128, 128, False, False, None), (m, 256, 128, False, False, None),
    (m, 128, 256, False, True, None), (m, 256, 128, False, True, None),
    (128, 384, m, True, False, fusion_stack.split_rows(m)),
    (256, 128, m, True, False, fusion_stack.split_rows(m)))]
K3_GEMMS += [(1000, 200, 72, False, False, None), (1000, 200, 72, False, True, None),
             (200, 130, 1000, True, False, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,a_t,b_t,split", K3_GEMMS)
@pytest.mark.parametrize("compute_bf16", [True, False], ids=["core", "f32"])
def test_gemm_core_converting_matches_matmul(cuda_device, m, n, k, a_t, b_t, split,
                                             compute_bf16):
    """The core with its converting producer (K3's f32 operands, rounded to
    bf16 as staged; "f32": the FMA check path) against the plain version:
    within 1e-4 of the output's max (sums in another order); a product split
    over its rows also gives B's column sums, within 1e-5 of the largest
    column's sum of |B|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(m * n + k)
    a = _randn(g, *((k, m) if a_t else (m, k))).to(cuda_device)
    b = _randn(g, *((n, k) if b_t else (k, n)), s=k ** -0.5).to(cuda_device)
    ops = dict(a_t=a_t, b_t=b_t, compute_bf16=compute_bf16)
    am, bm = (a.t() if a_t else a), (b.t() if b_t else b)
    want, _ = fusion_stack.gemm_core_plain(am, bm, compute_bf16=compute_bf16)
    if split:
        got, colsum = fusion_stack.gemm_core(a, b, split=split, **ops)
        torch.cuda.synchronize()
        assert (colsum - bm.sum(0)).abs().max() <= 1e-5 * bm.abs().sum(0).max()
    else:
        got = fusion_stack.gemm_core(a, b, **ops)
        torch.cuda.synchronize()
    assert _max_err(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("option", ["bias", "pre", "gelu", "relu", "mask", "aux gelu",
                                    "aux relu", "res", "all"])
def test_gemm_core_epilogue(cuda_device, option):
    """Each option of the Perceive layers' epilogue (bias, the pre-activation,
    act, mask * keep, act'(aux), residual) and all of them at once, on the
    core at a ragged shape, against the plain version within 1e-4."""
    g = torch.Generator().manual_seed(len(option))
    m, n, k = 777, 258, 136
    a = _randn(g, m, k).to(cuda_device)
    b = _randn(g, k, n, s=k ** -0.5).to(cuda_device)
    allopt = option == "all"
    kw = {}
    if option in ("bias", "pre", "all"):
        kw["bias"] = _randn(g, n, s=0.1).to(cuda_device)
    if option in ("gelu", "pre", "all"):
        kw["act"] = "gelu"
    if option == "relu":
        kw["act"] = "relu"
    if option in ("mask", "all"):
        kw["mask"] = (torch.rand(m, n, generator=g) > 0.1).to(cuda_device, torch.int8)
        kw["keep"] = 1 / 0.9
    if option.startswith("aux") or allopt:
        kw["aux"] = _randn(g, m, n).to(cuda_device)
        kw["aux_act"] = "relu" if option == "aux relu" else "gelu"
    if option in ("res", "all"):
        kw["res"] = _randn(g, m, n).to(cuda_device)
    want, want_pre = fusion_stack.gemm_core_plain(a, b, **kw)
    got, pre = fusion_stack.gemm_core(a, b, with_pre=True, **kw)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= 1e-4
    if option in ("pre", "all"):
        assert _max_err(pre, want_pre) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("r,l", [(6, 65), (2, 160), (3, 40)])
@pytest.mark.parametrize("compute_bf16", [True, False], ids=["bf16", "f32"])
def test_perceive_backward_is_deterministic(cuda_device, r, l, compute_bf16):
    """K3b twice on the same inputs: the same bits in dx and in all 16
    weight grads (fixed-order sums, no atomics)."""
    gen = torch.Generator().manual_seed(r + l)
    x, w, masks, cnt = _stack_inputs(gen, r, l)
    wl = tuple(t[0].to(cuda_device) for t in w)
    ml = tuple(m[0].to(cuda_device) for m in masks)
    xd, c = x.to(cuda_device), cnt[0].contiguous().to(cuda_device)
    gd = _randn(gen, *x.shape).to(cuda_device)
    kw = dict(heads=8, u=l, dropout_rate=0.05, activation="gelu", compute_bf16=compute_bf16)
    dx1, dw1 = fusion_stack.layer_backward_cuda(xd, gd, wl, c, ml, **kw)
    dx2, dw2 = fusion_stack.layer_backward_cuda(xd, gd, wl, c, ml, **kw)
    torch.cuda.synchronize()
    assert torch.equal(dx1, dx2)
    assert all(torch.equal(a, b) for a, b in zip(dw1, dw2))


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb,d", [(256, 16, 32), (64, 1, 32), (144, 4, 32), (49, 2, 16),
                                    (256, 4, 64)])
@pytest.mark.parametrize("layout", ["bf16", "f32 strided"])
def test_window_kernel_matches_plain(cuda_device, n, nb, d, layout):
    """bf16 output. "bf16": (B, H, n, d) tensors through the wrapper,
    within 1e-2 of the O(1) values (one bf16 ulp is 2**-8). "f32 strided":
    f32 views of one (B n, 3C) qkv buffer, as K1 launches the kernel,
    against the plain version at the kernel's rounding points (q and k
    normalised in f32, then rounded to bf16 with v, which a bf16 v
    selects), within 1e-2 of max(1, max|plain|), as ``chip_smoke.py``'s
    ``K2_TOL``: outputs up to ~4 put a bf16 rounding of 2**-6 in reach."""
    g = torch.Generator().manual_seed(n)
    h, b = 4, 2 * nb
    bias = (16 * torch.sigmoid(_randn(g, nb, h, n, n))).to(cuda_device)
    scale = torch.exp(torch.clamp(_randn(g, h, s=0.5) + 2.3, max=math.log(100.0)))
    scale = scale.to(cuda_device)
    before = flash_attention.launches
    if layout == "bf16":
        q, k, v = (_randn(g, b, h, n, d).to(cuda_device).bfloat16() for _ in range(3))
        got = flash_attention.flash_window_attention(q, k, v, bias, scale, cosine=True)
    else:
        c = h * d
        qkv = _randn(g, b * n, 3 * c).to(cuda_device)
        q, k, v = (qkv[:, i * c:(i + 1) * c].reshape(b, n, h, d).transpose(1, 2)
                   for i in range(3))
        out = torch.empty(b * n, c, dtype=torch.bfloat16, device=cuda_device)
        flash_attention.launch_window_attention(
            qkv, qkv[:, c:], qkv[:, 2 * c:], (n * 3 * c, d, 3 * c), bias, scale, out,
            (n * c, d, c), b, h, n, d, True)
        got = out.reshape(b, n, h, d).transpose(1, 2)
        v = v.bfloat16()
    assert flash_attention.launches == before + 1
    want = flash_attention.flash_window_attention_plain(q, k, v, bias, scale, cosine=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, n, d)
    of = 1.0 if layout == "bf16" else max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= 1e-2 * of


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", ["tanh", "exact"])
@pytest.mark.parametrize("b,n,c,h,nw", [(32, 256, 128, 4, 16), (8, 256, 256, 8, None),
                                        (4, 64, 1024, 32, None)])
def test_block_kernel_matches_plain(cuda_device, b, n, c, h, nw, gelu):
    """bf16 output: within 1e-2 of the output's max, with the tanh and with
    the erf gelu epilogue; one K1 and one K2 launch, counted as an erf
    block with the exact gelu."""
    g = torch.Generator().manual_seed(c)
    p = {
        "wqkv": _randn(g, 3 * c, c, s=c ** -0.5), "bqkv": _randn(g, 3 * c, s=0.15),
        "wproj": _randn(g, c, c, s=c ** -0.5), "bproj": _randn(g, c, s=0.15),
        "ln1_scale": 1 + _randn(g, c, s=0.05), "ln1_bias": _randn(g, c, s=0.05),
        "wfc1": _randn(g, 4 * c, c, s=c ** -0.5), "bfc1": _randn(g, 4 * c, s=0.15),
        "wfc2": _randn(g, c, 4 * c, s=(4 * c) ** -0.5), "bfc2": _randn(g, c, s=0.15),
        "ln2_scale": 1 + _randn(g, c, s=0.05), "ln2_bias": _randn(g, c, s=0.05),
        "logit_scale": torch.exp(torch.clamp(_randn(g, h, s=0.5) + 2.3,
                                             max=math.log(100.0))),
    }
    p = {k: v.to(cuda_device) for k, v in p.items()}
    x = _randn(g, b, n, c).to(cuda_device).bfloat16()
    bias = 16 * torch.sigmoid(_randn(g, h, n, n))
    if nw is not None:
        mask = torch.where(torch.rand(nw, n, n, generator=g) < 0.2, -100.0, 0.0)
        bias = bias[None] + mask[:, None]
    bias = bias.to(cuda_device)
    before = (swin_block_fusion.launches, flash_attention.launches,
              swin_block_fusion.launches_erf)
    got = swin_block_fusion.fused_swin_block(x, p, bias, h, True, gelu)
    assert (swin_block_fusion.launches, flash_attention.launches,
            swin_block_fusion.launches_erf) == (
        before[0] + 1, before[1] + 1, before[2] + (gelu == "exact"))
    want = swin_block_fusion.fused_swin_block_plain(x, p, bias, h, True, gelu)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("act,passes", [(swin_block_fusion.ACT_ERF, True),
                                        (swin_block_fusion.ACT_TANH, False)])
def test_gemm_erf_epilogue_is_the_exact_gelu(cuda_device, act, passes):
    """K1's GEMM with the erf epilogue, f32 out, on pre-activations over
    [-4, 4]: within 5e-5 absolute of the float64 exact gelu (f32 sums and
    ``erff``). The tanh epilogue, up to 4.7e-4 off, fails the same bound."""
    g = torch.Generator().manual_seed(21)
    m, n, k = 4096, 512, 128
    a = _randn(g, m, k).to(cuda_device, torch.bfloat16)
    w = _randn(g, n, k, s=k ** -0.5).to(cuda_device, torch.bfloat16)
    bias = (6 * torch.rand(n, generator=g) - 3).to(cuda_device)
    out = torch.empty(m, n, dtype=torch.float32, device=cuda_device)
    got = swin_block_fusion.gemm_bias_act(a, w, bias, out, act)
    pre = a.double() @ w.double().T + bias.double()
    torch.cuda.synchronize()
    inside = pre.abs() <= 4  # the range checked; the pre-activations spread past it
    assert pre.abs().max().item() > 4 and inside.float().mean().item() > 0.5
    gap = (got.double() - torch.nn.functional.gelu(pre))[inside].abs().max().item()
    assert (gap <= 5e-5) == passes, gap


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros(2, 2, 16, 32, device=cuda_device)  # f32: not taken
    bias = torch.zeros(1, 2, 16, 16, device=cuda_device)
    with pytest.raises(TypeError, match="bf16"):
        flash_attention.flash_window_attention(q, q, q, bias, cosine=True)
    x = torch.zeros(2, 16, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CPU"):
        swin_block_fusion.fused_swin_block(x, {}, torch.zeros(4, 16, 16), 4,
                                           compute_bf16=False)
    rows = torch.zeros(32 * 64 + 1, device=cuda_device)[1:].view(32, 64)  # off 16 bytes
    out = torch.empty(32, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention.launch_window_attention(
            rows, rows, rows, (16 * 64, 16, 64), bias, torch.ones(2, device=cuda_device),
            out, (16 * 32, 16, 32), 2, 2, 16, 16, True)


def _stack_inputs(gen, r, l, n=2, d=128, f=256, p=0.05):
    w = fusion_stack.StackWeights(
        *[_randn(gen, *shape, s=s) + base for shape, s, base in [
            ((n, d, d), d ** -0.5, 0), ((n, d), 0.1, 0), ((n, d, d), d ** -0.5, 0),
            ((n, d), 0.1, 0), ((n, d, d), d ** -0.5, 0), ((n, d), 0.1, 0),
            ((n, d, d), d ** -0.5, 0), ((n, d), 0.1, 0), ((n, d), 0.05, 1), ((n, d), 0.05, 0),
            ((n, d, f), d ** -0.5, 0), ((n, f), 0.1, 0), ((n, f, d), f ** -0.5, 0),
            ((n, d), 0.1, 0), ((n, d), 0.05, 1), ((n, d), 0.05, 0)]])
    x = _randn(gen, r, l, d)
    masks = tuple((torch.rand(n, r, l, width, generator=gen) >= p).to(torch.int8)
                  for width in (d, f, d))
    cnt = fusion_stack.sample_count_matrices(n, l, l, fusion_stack.prob_sparse_u(l, 5))
    return x, w, masks, cnt


@pytest.mark.cuda
@pytest.mark.parametrize("r,l", [(6, 65), (2, 160), (3, 40)])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("backward", ["kernel", "hybrid"])
def test_perceive_stack_kernels_match_plain(cuda_device, r, l, train, backward):
    """K3a forward and K3b backward through ``fused_perceive_stack`` on the
    card against the same call on the CPU (the plain versions), f32 with
    exhaustive ProbSparse (so that no near-tie of the measure can flip a
    selection): 1e-4 of the output's max (sums in another order), and
    the gradients of x and of the 16 stacked weights against one global
    scale; one K3a launch per layer forward, one K3b per layer backward
    (none with the hybrid backward, autograd over the plain layer)."""
    gen = torch.Generator().manual_seed(r * l)
    x, w, masks, cnt = _stack_inputs(gen, r, l)
    masks = masks if train else None
    p = 0.05 if train else 0.0

    def run(device):
        xs = x.to(device).requires_grad_(True)
        ws = [t.to(device).requires_grad_(True) for t in w]
        y = fusion_stack.fused_perceive_stack(
            xs, fusion_stack.StackWeights(*ws), cnt.to(device),
            None if masks is None else tuple(m.to(device) for m in masks),
            heads=8, factor=10 ** 6, dropout_rate=p, compute_bf16=False,
            backward=backward)
        torch.sin(y).sum().backward()
        return y.detach().cpu(), xs.grad.cpu(), [t.grad.cpu() for t in ws]

    before = (fusion_stack.launches_fwd, fusion_stack.launches_bwd)
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert (fusion_stack.launches_fwd, fusion_stack.launches_bwd) == (
        before[0] + 2, before[1] + (2 if backward == "kernel" else 0))
    want = run("cpu")
    assert (got[0] - want[0]).abs().max() <= 1e-4 * want[0].abs().max()
    assert (got[1] - want[1]).abs().max() <= 1e-4 * want[1].abs().max()
    scale = max(g.abs().max() for g in want[2])
    for a, b in zip(got[2], want[2]):
        assert (a - b).abs().max() <= 1e-4 * scale


@pytest.mark.cuda
def test_perceive_layer_kernel_bf16_and_selection(cuda_device):
    """bf16 operands with exhaustive u: within 2e-2 of the output's max (a
    bf16 rounding may land on the other side); the selection the kernel
    reports equals the plain version's at f32 with the real u."""
    gen = torch.Generator().manual_seed(0)
    x, w, masks, cnt = _stack_inputs(gen, 4, 65)
    wl = tuple(t[0].to(cuda_device) for t in w)
    ml = tuple(m[0].to(cuda_device) for m in masks)
    xd, c = x.to(cuda_device), cnt[0].contiguous().to(cuda_device)
    kw = dict(heads=8, dropout_rate=0.05, activation="gelu")
    got = fusion_stack.layer_forward_cuda(xd, wl, c, ml, u=65, compute_bf16=True, **kw)
    want = fusion_stack.layer_forward(xd, wl, c, ml, u=65, mm_dtype=torch.bfloat16, **kw)
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
    sel = torch.empty(4, 8, 65, dtype=torch.int8, device=cuda_device)
    fusion_stack.layer_forward_cuda(xd, wl, c, ml, u=25, compute_bf16=False, selection=sel,
                                    **kw)
    _, inner = fusion_stack.layer_forward(xd, wl, c, ml, u=25, mm_dtype=torch.float32,
                                          internals=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(sel.bool(), inner["saved"][4][..., 0])
    assert int(sel.sum(-1).min()) >= 25  # ties are kept


# K3a's geometries (rows, tokens): the flagship train step's five stacks and
# the DinoV2 frame encoder at batch 1; K3b's three (the input-pass stacks).
K3A_GEOMS = [(384, 65), (288, 65), (16, 160), (16, 120), (16, 40), (24, 1370)]
K3B_GEOMS = [(384, 65), (16, 160), (16, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("r,l", K3A_GEOMS)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_perceive_stack_forward_matches_plain(cuda_device, r, l, train):
    """K3a, two layers in one call, against the plain stack on the card:
    bf16 with exhaustive ProbSparse within 2e-2 of the output's max (a bf16
    rounding may land on the other side), f32 within 1e-4; one launch
    counted per layer."""
    gen = torch.Generator().manual_seed(r + l)
    x, w, masks, cnt = _stack_inputs(gen, r, l)
    xd, wd, cd = x.to(cuda_device), fusion_stack.StackWeights(*[t.to(cuda_device) for t in w]), \
        cnt.to(cuda_device)
    md = tuple(m.to(cuda_device) for m in masks) if train else None
    p = 0.05 if train else 0.0
    for bf16, tol in ((True, 2e-2), (False, 1e-4)):
        before = fusion_stack.launches_fwd
        got = fusion_stack.fused_perceive_stack(xd, wd, cd, md, heads=8, factor=10 ** 6,
                                                dropout_rate=p, compute_bf16=bf16)
        assert fusion_stack.launches_fwd == before + 2
        want = fusion_stack.stack_reference(xd, wd, cd, md, heads=8, u=l, dropout_rate=p,
                                            compute_bf16=bf16)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= tol, bf16


@pytest.mark.cuda
@pytest.mark.parametrize("r,l", K3B_GEOMS)
def test_perceive_backward_selection_is_the_forwards(cuda_device, r, l):
    """bf16 with the real u: the selection K3b's recompute made and
    differentiated is, query by query, the one K3a made on the same layer
    input."""
    gen = torch.Generator().manual_seed(3 * r + l)
    x, w, masks, cnt = _stack_inputs(gen, r, l)
    wl = tuple(t[0].to(cuda_device) for t in w)
    ml = tuple(m[0].to(cuda_device) for m in masks)
    xd, c = x.to(cuda_device), cnt[0].contiguous().to(cuda_device)
    kw = dict(heads=8, u=fusion_stack.prob_sparse_u(l, 5), dropout_rate=0.05,
              activation="gelu", compute_bf16=True)
    fwd = torch.empty(r, 8, l, dtype=torch.int8, device=cuda_device)
    bwd = torch.zeros_like(fwd)
    fusion_stack.layer_forward_cuda(xd, wl, c, ml, selection=fwd, **kw)
    fusion_stack.layer_backward_cuda(xd, torch.ones_like(xd), wl, c, ml, selection=bwd, **kw)
    torch.cuda.synchronize()
    assert torch.equal(fwd, bwd)
    assert int(fwd.sum(-1).min()) >= kw["u"]  # ties are kept


@pytest.mark.cuda
@pytest.mark.parametrize("r,l", K3A_GEOMS)
def test_perceive_bf16_selection_is_the_rank_test_of_stored_qk(cuda_device, r, l):
    """bf16 with the real u: the selection of K3a's tensor-core measure is
    the rank test ``#{j : m_j > m_i} < u`` (ties kept) of the measure
    rebuilt in f64 from the bf16 q|k the kernel stored and the counts, the
    products exact; only the order of the kernel's f32 sums differs, so a
    selection may differ only within 1e-4 of the max measure of the
    boundary."""
    gen = torch.Generator().manual_seed(5 * r + l)
    x, w, masks, cnt = _stack_inputs(gen, r, l)
    wl = tuple(t[0].to(cuda_device) for t in w)
    ml = tuple(m[0].to(cuda_device) for m in masks)
    xd, c = x.to(cuda_device), cnt[0].contiguous().to(cuda_device)
    h, u = 8, fusion_stack.prob_sparse_u(l, 5)
    sel = torch.empty(r, h, l, dtype=torch.int8, device=cuda_device)
    fusion_stack.layer_forward_cuda(xd, wl, c, ml, heads=h, u=u, dropout_rate=0.05,
                                    activation="gelu", compute_bf16=True, selection=sel)
    torch.cuda.synchronize()
    ws = fusion_stack._workspaces[cuda_device if cuda_device.index is not None
                                  else torch.device("cuda", torch.cuda.current_device())]
    qk = ws[:r * l * 128].view(torch.bfloat16).view(r, l, 2, h, -1)
    c = c.double()
    assert int(sel.sum(-1).min()) >= u  # ties are kept
    for head in range(h):
        q, k = qk[:, :, 0, head].double(), qk[:, :, 1, head].double()
        s = q @ k.transpose(-1, -2)
        top = torch.where(c > 0, s, torch.full_like(s, -torch.inf)).amax(-1)
        meas = top - (s * c).sum(-1) / l
        srt = meas.sort(-1, descending=True).values
        want = meas >= srt[:, u - 1:u]
        gap = torch.where(want, meas - srt[:, u:u + 1], srt[:, u - 1:u] - meas)
        near = gap <= 1e-4 * meas.abs().amax(-1, keepdim=True)
        differ = sel[:, head].bool() != want
        assert not (differ & ~near).any(), (head, int(differ.sum()))


def _align4(n):
    return -(-n // 4) * 4


@pytest.mark.cuda
@pytest.mark.parametrize("r,l", [(24, 65), (4, 1370)])
def test_perceive_stored_bf16_operands_are_rounded_f32(cuda_device, r, l):
    """K3a keeps q, k, att and a1 as bf16, since every consumer rounds them:
    q|k and a1 are the bits of the same GEMM's f32 result rounded (its
    epilogue alone, on ``gemm_core``), att the f32 attention of the stored
    q, k and v (the selected queries' softmax and the mean of V), to one
    bf16 ulp plus 2^-20 of max|v|: its f32 sums run in another order, which
    matters where p.v cancels to near 0."""
    gen = torch.Generator().manual_seed(l)
    x, w, masks, cnt = _stack_inputs(gen, r, l)
    wl = tuple(t[0].to(cuda_device) for t in w)
    ml = tuple(m[0].to(cuda_device) for m in masks)
    xd, c = x.to(cuda_device), cnt[0].contiguous().to(cuda_device)
    d, f, h, m = 128, 256, 8, r * l
    u = fusion_stack.prob_sparse_u(l, 5)
    sel = torch.empty(r, h, l, dtype=torch.int8, device=cuda_device)
    fusion_stack.layer_forward_cuda(xd, wl, c, ml, heads=h, u=u, dropout_rate=0.05,
                                    activation="gelu", compute_bf16=True, selection=sel)
    torch.cuda.synchronize()
    ws = fusion_stack._workspaces[cuda_device if cuda_device.index is not None
                                  else torch.device("cuda", torch.cuda.current_device())]
    qk = ws[:m * d].view(torch.bfloat16).view(m, 2 * d)
    v = ws[m * d:2 * m * d].view(m, d)
    att_at = 3 * m * d + _align4(m * h) + _align4(-(-m * h // 4))
    att = ws[att_at:att_at + m * d // 2].view(torch.bfloat16).view(m, d)
    xn1 = ws[att_at + 2 * m * d:att_at + 3 * m * d].view(m, d)
    a1_at = att_at + 3 * m * d + m * f
    a1 = ws[a1_at:a1_at + m * f // 2].view(torch.bfloat16).view(m, f)
    kw = fusion_stack.kernel_weights(wl)
    qkv = fusion_stack.gemm_core(xd.view(m, d), kw.wqkv, bias=kw.bqkv)
    assert torch.equal(qk, qkv[:, :2 * d].bfloat16())
    assert torch.equal(v, qkv[:, 2 * d:])
    keep = float(np.float32(1 / 0.95))
    a1_f32 = fusion_stack.gemm_core(xn1, wl[10], bias=wl[11], act="gelu",
                                    mask=ml[1].view(m, f), keep=keep)
    assert torch.equal(a1, a1_f32.bfloat16())
    q = qk[:, :d].float().view(r, l, h, -1).permute(0, 2, 1, 3)
    k = qk[:, d:].float().view(r, l, h, -1).permute(0, 2, 1, 3)
    vh = v.view(r, l, h, -1).permute(0, 2, 1, 3)
    chosen = sel.bool()
    mean = vh.mean(2, keepdim=True).expand_as(vh)
    p = torch.softmax(q @ k.transpose(-1, -2) * 0.25, dim=-1)
    want = torch.where(chosen[..., None], p @ vh, mean).permute(0, 2, 1, 3).reshape(m, d)
    bound = want.abs() * 2 ** -7 + vh.abs().max() * 2 ** -20
    assert ((att.float() - want).abs() <= bound).all()


@pytest.mark.cuda
def test_perceive_kernels_reject_what_they_do_not_take(cuda_device):
    gen = torch.Generator().manual_seed(1)
    x, w, _, cnt = _stack_inputs(gen, 2, 40)
    wl = tuple(t[0].to(cuda_device) for t in w)
    c = cnt[0].contiguous().to(cuda_device)
    kw = dict(heads=8, u=20, dropout_rate=0.0, activation="gelu", compute_bf16=True)
    with pytest.raises(ValueError, match="f32"):
        fusion_stack.layer_forward_cuda(x.to(cuda_device).bfloat16(), wl, c, None, **kw)
    with pytest.raises(ValueError, match="cnt"):
        fusion_stack.layer_forward_cuda(x.to(cuda_device), wl, c[:10], None, **kw)
    with pytest.raises(ValueError, match="width"):
        fusion_stack.layer_forward_cuda(x.to(cuda_device), wl, c, None,
                                        **dict(kw, heads=7))


def _dense_views(g, b, l, h, widths, device, dtype):
    """Strided (B, L, H, w) views of one (B, L, H, sum(widths)) buffer, one
    per width, as the ViT's q, k, v are views of its qkv rows."""
    buf = _randn(g, b, l, h, sum(widths)).to(device, dtype)
    starts = np.cumsum([0, *widths])
    return [buf[..., s:s + w] for s, w in zip(starts, widths)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,l_q,l_k,e,e_v", [(4, 64, 64, 64, 64), (3, 130, 130, 104, 104),
                                              (2, 70, 200, 32, 48), (5, 600, 600, 64, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layout", ["bhle", "views"])
def test_dense_kernel_matches_plain(cuda_device, bh, l_q, l_k, e, e_v, causal, dtype, layout):
    """K4 at a small, a ragged (E 104, L 130), an L_q != L_k and a longer
    shape: within 1e-2 of the output's max in bf16 (a bf16 rounding of the
    output may land on the other side), 1e-5 in f32 (sums in another
    order); one launch per call. "bhle": contiguous (BH, L, E) tensors;
    "views": strided (B, L, H, E) views (H 2, B = BH) through
    ``dense_attention_blhe``, the output in (B, L, H, E_v) memory."""
    g = torch.Generator().manual_seed(l_q * e)
    before = flash_attention.dense_launches
    if layout == "bhle":
        q = _randn(g, bh, l_q, e).to(cuda_device, dtype)
        k = _randn(g, bh, l_k, e).to(cuda_device, dtype)
        v = _randn(g, bh, l_k, e_v).to(cuda_device, dtype)
        got = flash_attention.flash_attention_bhle(q, k, v, causal, e ** -0.5)
    else:
        (q,) = _dense_views(g, bh, l_q, 2, [e], cuda_device, dtype)
        k, v = _dense_views(g, bh, l_k, 2, [e, e_v], cuda_device, dtype)
        got = flash_attention.dense_attention_blhe(q, k, v, causal, e ** -0.5)
        assert got.shape == (bh, l_q, 2, e_v) and got.is_contiguous()
        got, q, k, v = (t.transpose(1, 2) for t in (got, q, k, v))
    assert flash_attention.dense_launches == before + 1
    want = flash_attention.attention_bhle_plain(q, k, v, causal, e ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape == (*q.shape[:-2], l_q, e_v)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert (got.float() - want.float()).abs().max() <= tol * want.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_dot_product_attention_flash_reads_views_in_place(cuda_device, causal):
    """``dot_product_attention(impl="flash")`` on the card: one K4 launch
    per call on the ViT's views of its qkv rows (E % 16 == 0), one
    allocation (the output: no contiguous copy of q, k or v), and the plain
    version's result within 1e-2 of its max."""
    g = torch.Generator().manual_seed(7)
    q, k, v = _dense_views(g, 2, 600, 4, [64, 64, 64], cuda_device, torch.bfloat16)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    before = flash_attention.dense_launches
    got = attention.dot_product_attention(q, k, v, causal=causal, impl="flash")
    assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 1
    assert flash_attention.dense_launches == before + 1
    want = flash_attention.attention_bhle_plain(*(t.transpose(1, 2) for t in (q, k, v)),
                                                causal, 64 ** -0.5).transpose(1, 2)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, 600, 4, 64)
    assert (got.float() - want.float()).abs().max() <= 1e-2 * want.float().abs().max()


@pytest.mark.cuda
def test_dense_kernel_gradient(cuda_device):
    """K4's Function: the kernel forward carries a gradient, equal to
    autograd of the plain version (its backward recomputes that)."""
    g = torch.Generator().manual_seed(3)
    leaves = [_randn(g, 6, 300, 64).to(cuda_device, torch.bfloat16) for _ in range(3)]
    weight = _randn(g, 6, 300, 64).to(cuda_device)

    def grads(fn):
        xs = [t.detach().requires_grad_(True) for t in leaves]
        return torch.autograd.grad((fn(*xs).float() * weight).sum(), xs)

    before = flash_attention.dense_launches
    got = grads(lambda q, k, v: flash_attention.flash_attention_bhle(q, k, v, True, 0.125))
    assert flash_attention.dense_launches == before + 1
    want = grads(lambda q, k, v: flash_attention.attention_bhle_plain(
        q.float(), k.float(), v.float(), True, 0.125).to(q.dtype))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_dense_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(2, 16, 136, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="up to 128"):
        flash_attention.flash_attention_bhle(q, q, q, False, 1.0)
    x = torch.zeros(2, 16, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="all bf16 or all f32"):
        flash_attention.flash_attention_bhle(x, x.float(), x, False, 1.0)
    with pytest.raises(ValueError, match="lie on"):
        flash_attention.flash_attention_bhle(x, x.cpu(), x, False, 1.0)


@pytest.mark.cuda
def test_perceive_stack_refuses_too_many_tokens(cuda_device):
    """At the DinoV2 frame encoder's 1370 tokens K3a runs (its core keeps no
    L x L tile: one launch per layer), while K3b, whose attention block
    keeps one, is refused: a kernel-backward stack that needs a gradient
    raises, naming the cap, before any launch."""
    gen = torch.Generator().manual_seed(2)
    _, w, _, _ = _stack_inputs(gen, 1, 40)
    x = torch.zeros(2, 1370, 128)
    cnt = fusion_stack.sample_count_matrices(2, 1370, 1370, 40)
    wd = fusion_stack.StackWeights(*[t.to(cuda_device) for t in w])
    before = fusion_stack.launches_fwd
    y = fusion_stack.fused_perceive_stack(x.to(cuda_device), wd, cnt.to(cuda_device), None,
                                          heads=8)
    torch.cuda.synchronize()
    assert fusion_stack.launches_fwd == before + 2 and torch.isfinite(y).all()
    before = (fusion_stack.launches_fwd, fusion_stack.launches_bwd)
    with pytest.raises(ValueError, match="at most 208 tokens"):
        fusion_stack.fused_perceive_stack(
            x.to(cuda_device).requires_grad_(True), wd, cnt.to(cuda_device), None, heads=8)
    assert (fusion_stack.launches_fwd, fusion_stack.launches_bwd) == before


# ---------------------------------------------------- registered ops --- #


def _op_cases(gen, dev):
    """Each registered op's CUDA inputs at a shape its path gives it: K1's
    qkv GEMM, K2 on f32 strided views of its output written in (B, n, H, d)
    memory and on bf16 tensors, K1's tail, K3a (eval and train masks), K4
    on the ViT's (B, L, H, E) views."""
    c, n, h, b = 128, 256, 4, 8
    x = _randn(gen, b * n, c).to(dev, torch.bfloat16)
    w = _randn(gen, 3 * c, c, s=c ** -0.5).to(dev, torch.bfloat16)
    qkv = _randn(gen, b, n, 3, h, c // h).to(dev)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    bias, scale = _randn(gen, 4, h, n, n).to(dev), _randn(gen, h).abs().to(dev) + 1
    tail = [_randn(gen, *s, s=0.1).to(dev, dt) + base for s, dt, base in (
        ((c, c), torch.bfloat16, 0), ((c,), torch.float32, 0), ((c,), torch.float32, 1),
        ((c,), torch.float32, 0), ((4 * c, c), torch.bfloat16, 0), ((4 * c,), torch.float32, 0),
        ((c, 4 * c), torch.bfloat16, 0), ((c,), torch.float32, 0), ((c,), torch.float32, 1),
        ((c,), torch.float32, 0))]
    xs, ws, masks, cnt = _stack_inputs(gen, 6, 65)
    ws, masks, cnt = [t.to(dev) for t in ws], [m.to(dev) for m in masks], cnt.to(dev)
    qkv_vit = _randn(gen, 2, 600, 3, 12, 64).to(dev, torch.bfloat16)
    qv, kv, vv = (qkv_vit[:, :, i].transpose(1, 2) for i in range(3))
    return [
        (swin_block_fusion.gemm_bias_act_op, (x, w, _randn(gen, 3 * c).to(dev), 0,
                                              torch.float32)),
        (swin_block_fusion.gemm_bias_act_op, (x, w, _randn(gen, 3 * c).to(dev), 1,
                                              torch.bfloat16)),
        (flash_attention.window_attention, (q, k, v, bias, scale, True, True)),
        (flash_attention.window_attention, (q.bfloat16(), k.bfloat16(), v.bfloat16(), bias,
                                            scale, True, False)),
        (swin_block_fusion.swin_block_tail, (_randn(gen, b * n, c).to(dev),
                                             _randn(gen, b * n, c).to(dev, torch.bfloat16),
                                             *tail)),
        (fusion_stack.perceive_stack, (xs.to(dev), ws, [], cnt, [], 8, 65, 0.0, "gelu", True,
                                       False)),
        (fusion_stack.perceive_stack, (xs.to(dev), ws, [], cnt, masks, 8, 65, 0.05, "gelu",
                                       False, True)),
        (flash_attention.dense_attention, (qv, kv, vv, False, 0.125, True)),
    ]


@pytest.mark.cuda
def test_registered_ops_match_plain_on_the_card(cuda_device):
    """Each op's CUDA implementation (the kernel) against its CPU
    implementation (the plain version) on the same inputs, with the
    layout its fake implementation gives, and ``opcheck`` on the card;
    K3a exhaustive (u = L: no selection near a tie). Within 5e-2 of the
    max: K3a in bf16 over two layers (phase 6 holds it at 2e-2), the rest
    a few bf16 ulps."""
    gen = torch.Generator().manual_seed(0)
    for fn, args in _op_cases(gen, cuda_device):
        torch.library.opcheck(fn, args)
        got = fn(*args)
        want = fn(*[[t.cpu() for t in a] if isinstance(a, list)
                    else a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype and g.stride() == w.stride()
            if w.numel():
                assert _max_err(g.cpu(), w) <= 5e-2, fn


@pytest.mark.cuda
def test_exported_forward_matches_live_on_the_card(cuda_device, monkeypatch):
    """A tanh-gelu SwinV2 Routeformer at test widths (16-wide heads, which
    K2 takes) with the fused stack on the card: exported and reloaded, it
    launches K1, K2 and K3a as the live forward does and gives the same
    bits (else within 1e-3 of the max)."""
    from routeformer_torch import ExportedModel, export_model
    from routeformer_torch.flagship import init_weights
    from routeformer_torch.models import Routeformer, RouteformerConfig
    from routeformer_torch.models.gps_backbone import GPSBackboneConfig
    from routeformer_torch.models.video_backbone import TimmBackboneConfig, swin
    from routeformer_torch.serve import _eval_forward

    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    monkeypatch.setitem(swin.SWIN_PRESETS, "swinv2_card_test", swin.SwinPreset(
        img_size=64, patch_size=4, embed_dim=32, depths=(2, 2), heads=(2, 4), window=4))
    cfg = RouteformerConfig(
        gps_backbone_config=GPSBackboneConfig(seq_len=8, label_len=8, pred_len=6, d_model=32,
                                              n_heads=4, e_layers=2, d_layers=1, d_ff=64,
                                              factor=4, dropout=0.0),
        video_backbone_config=TimmBackboneConfig(model_type="swinv2_card_test",
                                                 compute_dtype="bfloat16", gelu="tanh",
                                                 pad_to_square=False),
        decoder_mode="smart", with_video=True, with_gaze=True, dense_prediction=True,
        image_embedding_size=16, encoder_hidden_size=16, encoder_heads=8, encoder_layers=2,
        encoder_d_ff=256, cross_modal_decoder_heads=4, cross_modal_decoder_layers=2,
        feature_dropout=0.0, view_dropout=0.0, gaze_dropout=0.0, output_fps=5, video_fps=1,
        gaze_fps=1)
    model = Routeformer(cfg)
    init_weights(model, 0)
    model = model.to(cuda_device).eval()
    rng = np.random.RandomState(0)
    batch = {"gps": np.cumsum(rng.randn(1, 8, 2), axis=1).astype(np.float32),
             **{k: rng.uniform(size=(1, 8, 64, 64, 3)).astype(np.float32)
                for k in ("left_video", "right_video", "front_video")},
             "gaze": rng.uniform(size=(1, 40, 2)).astype(np.float32)}

    def counts():
        return (swin_block_fusion.launches, flash_attention.launches,
                fusion_stack.launches_fwd)

    before = counts()
    with torch.inference_mode():
        want = model({k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()})[0]
    torch.cuda.synchronize()
    live = tuple(a - b for a, b in zip(counts(), before))
    served = ExportedModel(export_model(model, batch), _eval_forward(model)[1])
    before = counts()
    got = served(batch)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == live and min(live) > 0
    assert torch.equal(got, want) or _max_err(got, want) <= 1e-3


# ------------------------------------------- no synchronisation --- #


def _small_routeformer(video_backbone, model_type, **kw):
    from routeformer_torch.flagship import init_weights
    from routeformer_torch.models import Routeformer, RouteformerConfig
    from routeformer_torch.models.gps_backbone import GPSBackboneConfig
    from routeformer_torch.models.video_backbone import TimmBackboneConfig

    cfg = RouteformerConfig(
        gps_backbone_config=GPSBackboneConfig(seq_len=8, label_len=8, pred_len=6, d_model=32,
                                              n_heads=4, e_layers=2, d_layers=1, d_ff=64,
                                              factor=4, dropout=0.0),
        video_backbone_config=TimmBackboneConfig(model_type=model_type,
                                                 compute_dtype="bfloat16", gelu="tanh",
                                                 cache_enabled=False),
        decoder_mode="smart", with_video=True, with_gaze=True, dense_prediction=True,
        image_embedding_size=16, encoder_hidden_size=16, encoder_heads=8, encoder_layers=2,
        encoder_d_ff=256, cross_modal_decoder_heads=4, cross_modal_decoder_layers=2,
        output_fps=5, video_fps=1, gaze_fps=1, **kw)
    model = Routeformer(cfg, video_backbone=video_backbone)
    init_weights(model, 0)
    return model


def _clips(gen, dev, steps, side, pin=False):
    """A batch of two clips: uint8 frames, gps and gaze, as the benchmark's."""
    t = lambda x: x.pin_memory() if pin else x.to(dev)  # noqa: E731
    out = {k: t(torch.randint(0, 256, (2, steps, side, side, 3), generator=gen,
                              dtype=torch.uint8))
           for k in ("left_video", "right_video", "front_video")}
    out["gps"] = t(torch.cumsum(torch.randn(2, steps, 2, generator=gen), dim=1))
    out["gaze"] = t(torch.rand(2, 5 * steps, 2, generator=gen))
    return out


def _never_synchronising(fn):
    """``fn()`` with every synchronising CUDA call raising."""
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(before)


@pytest.mark.cuda
def test_train_step_and_request_never_synchronise(cuda_device, monkeypatch):
    """Between a unit's start and its answer's copy the host never waits for
    the card: a train step of a small tanh-SwinV2 Routeformer (view and gaze
    dropout, dense prediction, the fused stack) under ``make_train_step``,
    and a request of a small DinoV2-class Routeformer (K4's route at 577
    tokens) under ``ServingModel``, each after a warm unit, raise nothing in
    the sync debug mode's ``error``."""
    from routeformer_torch.models.video_backbone import DinoV2, SwinV2Backbone, swin, vit
    from routeformer_torch.optimizers import build_optimizer
    from routeformer_torch.parallel import make_train_step
    from routeformer_torch.serve import ServingModel
    from routeformer_torch.train import TrainingLosses, routeformer_training_loss

    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    monkeypatch.setitem(swin.SWIN_PRESETS, "swinv2_card_test", swin.SwinPreset(
        img_size=64, patch_size=4, embed_dim=32, depths=(2, 2), heads=(2, 4), window=4))
    monkeypatch.setitem(vit.PRESETS, "vit_card_test", vit.ViTPreset(96, 4, 128, 2, 2))
    gen = torch.Generator().manual_seed(0)

    model = _small_routeformer(SwinV2Backbone, "swinv2_card_test", view_dropout=0.6,
                               gaze_dropout=0.5, feature_dropout=0.05).to(cuda_device)
    optimizer = build_optimizer(model)
    optimizer.count = 12  # past the warm-up's rate 0
    losses = TrainingLosses.from_config(model.configs)
    step = make_train_step(model, optimizer, lambda m, i, t, e: routeformer_training_loss(
        m, i, t, e, losses))
    batches = [(_clips(gen, cuda_device, 8, 64), _clips(gen, cuda_device, 6, 64))
               for _ in range(2)]
    step(*batches[0], 12)  # builds the kernels, the optimizer's state and the caches
    metrics = _never_synchronising(lambda: step(*batches[1], 12))
    assert torch.isfinite(metrics["total_loss"]) and torch.isfinite(metrics["grad_norm"])

    serving = ServingModel(_small_routeformer(DinoV2, "vit_card_test").to(cuda_device),
                           cuda_device)
    requests = [_clips(gen, cuda_device, 8, 96, pin=True) for _ in range(2)]
    serving(requests[0])
    before = flash_attention.dense_launches
    gps, dense = _never_synchronising(lambda: serving(requests[1]))
    gps, dense = gps.cpu(), dense.cpu()
    assert flash_attention.dense_launches - before == 2  # K4 in both blocks
    assert gps.shape == (2, 6, 2) and torch.isfinite(gps).all() and torch.isfinite(dense).all()
