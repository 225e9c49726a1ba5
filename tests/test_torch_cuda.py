"""The CUDA kernels K1 and K2 against their plain versions on a card.

Marked ``cuda``: without a card every test skips. The file imports no JAX,
so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from routeformer_torch.ops import flash_attention, swin_block_fusion


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _randn(gen, *shape, s=1.0):
    return torch.randn(*shape, generator=gen) * s


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb,d", [(256, 16, 32), (64, 1, 32), (144, 4, 32), (49, 2, 16)])
def test_window_kernel_matches_plain(cuda_device, n, nb, d):
    """bf16 output: within 1e-2 of the O(1) values (one bf16 ulp is 2**-8)."""
    g = torch.Generator().manual_seed(n)
    h = 4
    q, k, v = (_randn(g, 2 * nb, h, n, d).to(cuda_device).bfloat16() for _ in range(3))
    bias = (16 * torch.sigmoid(_randn(g, nb, h, n, n))).to(cuda_device)
    scale = torch.exp(torch.clamp(_randn(g, h, s=0.5) + 2.3, max=math.log(100.0)))
    scale = scale.to(cuda_device)
    before = flash_attention.launches
    got = flash_attention.flash_window_attention(q, k, v, bias, scale, cosine=True)
    assert flash_attention.launches == before + 1
    want = flash_attention.flash_window_attention_plain(q, k, v, bias, scale, cosine=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,h,nw", [(32, 256, 128, 4, 16), (8, 256, 256, 8, None),
                                        (4, 64, 1024, 32, None)])
def test_block_kernel_matches_plain(cuda_device, b, n, c, h, nw):
    """bf16 output: within 1e-2 of the output's max."""
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
    before = (swin_block_fusion.launches, flash_attention.launches)
    got = swin_block_fusion.fused_swin_block(x, p, bias, h, True)
    assert (swin_block_fusion.launches, flash_attention.launches) == (
        before[0] + 1, before[1] + 1)
    want = swin_block_fusion.fused_swin_block_plain(x, p, bias, h, True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item()


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
