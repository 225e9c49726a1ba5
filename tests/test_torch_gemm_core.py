"""What surrounds the Hopper GEMM core on the CPU: K3b's plan of its
weight-gradient splits and workspace, and K1's cache of what a SwinV2 block
derives from its parameters (reused across calls, rebuilt after an in-place
update or ``load_flax_params``, outputs and gradients unchanged). The core
itself is held against ``torch.matmul`` on a card (``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
from flax import nnx

from routeformer_tpu.models.video_backbone import SwinV2Backbone as JaxSwin
from routeformer_tpu.models.video_backbone import TimmBackboneConfig as JaxTimmConfig
from routeformer_torch.convert import load_flax_params
from routeformer_torch.models.video_backbone import SwinV2Backbone, TimmBackboneConfig
from routeformer_torch.models.video_backbone.swin import SwinBlock
from routeformer_torch.ops import fusion_stack, swin_block_fusion
from test_torch_models import export_params

D, F, H = 128, 256, 8
CORE_K = 64  # the GEMM core's k-step (gemm_sm90.cuh BK)
# Rows M = R L of every Perceive stack at the flagship train step (batch 16:
# frame, frame target, video, video target, gaze) and at batch-1 serving.
FLAGSHIP_ROWS = [384 * 65, 288 * 65, 16 * 160, 16 * 120, 16 * 40, 24 * 65, 160, 40]


@pytest.mark.parametrize("m", FLAGSHIP_ROWS)
def test_split_plan_covers_the_rows_within_limits(m):
    """The splits of X^T dY cover the m rows exactly once, each a whole
    number of the core's k-steps; at most SPLITS of them; the core's tiles
    of every weight-gradient product (D x 3D, D x D, D x F, F x D) and the
    FMA path's grid stay within CUDA's limits; the workspace holds the
    intermediates, each split's partial products and column sums, and the
    LayerNorm partials."""
    rows = fusion_stack.split_rows(m)
    splits = -(-m // rows)
    assert rows % CORE_K == 0 and rows >= CORE_K
    assert (splits - 1) * rows < m <= splits * rows
    assert 1 <= splits <= fusion_stack.SPLITS
    for mm, n in ((D, 3 * D), (D, D), (D, F), (F, D)):
        assert -(-mm // 128) * -(-n // 128) * splits < 2 ** 30
    assert -(-m // 64) <= 65535  # the FMA GEMM's grid.y (64-row tiles)
    # qkv, att, x1, xn1, f1, a1, z, stage, bf16 copies of x and xn1; the
    # measures (M H floats) and the int8 selection, each rounded up to 16 bytes
    fwd = (m * (3 * D + D + D + D + F + F + D + D + D // 2 + D // 2) + -(-m * H // 4) * 4
           + -(-m * H // 16) * 4)
    bwd = m * (D + D + F + D + D + D + D + 3 * D)
    partials = splits * (D * 3 * D + D * D + D * F + F * D + 3 * D + D + F + D)
    ln = 2 * fusion_stack.LN_BLOCKS * 2 * D
    assert fusion_stack.workspace_floats(m, D, F, H) == fwd
    assert fusion_stack.workspace_floats(m, D, F, H, splits) == fwd + bwd + partials + ln


def _block(shift):
    torch.manual_seed(0)
    blk = SwinBlock(32, 2, 4, shift, (8, 8), torch.bfloat16, gelu_approximate=True)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return blk


@pytest.mark.parametrize("shift", [0, 2], ids=["plain", "shifted"])
def test_derived_weights_reused_until_updated_in_place(shift):
    """Without autograd recording, the qkv bias, the logit scale, the
    position bias and the kernel's bf16 weights are built once and reused;
    an in-place update of a source (an optimizer step) rebuilds exactly what
    it feeds, with the new values."""
    blk = _block(shift)
    a = blk.attn
    with torch.no_grad():
        first, bias = blk.fused_params(), blk.fused_bias()
        again = blk.fused_params()
        assert again["bqkv"] is first["bqkv"] and again["logit_scale"] is first["logit_scale"]
        assert blk.fused_bias() is bias
        wb = swin_block_fusion._bf16_weights(first)
        assert swin_block_fusion._bf16_weights(blk.fused_params()) is wb
        for w, key in zip(wb, ("wqkv", "wproj", "wfc1", "wfc2")):
            torch.testing.assert_close(w, first[key].bfloat16(), rtol=0, atol=0)

        a.q_bias.add_(1.0)
        a.qkv.weight.mul_(2.0)
        a.cpb_fc2.weight.mul_(0.5)
        after = blk.fused_params()
        assert after["bqkv"] is not first["bqkv"]
        assert after["logit_scale"] is first["logit_scale"]
        torch.testing.assert_close(after["bqkv"], a.qkv_bias(), rtol=0, atol=0)
        torch.testing.assert_close(blk.fused_bias(), _fresh_bias(blk), rtol=0, atol=0)
        assert blk.fused_bias() is not bias
        wb2 = swin_block_fusion._bf16_weights(after)
        assert wb2 is not wb
        torch.testing.assert_close(wb2[0], a.qkv.weight.bfloat16(), rtol=0, atol=0)


def _fresh_bias(blk):
    bias = blk.attn.get_bias()
    return bias if blk.attn_mask is None else bias[None] + blk.attn_mask[:, None]


def test_derived_weights_keep_outputs_and_gradients(rng):
    """The block's output with the cached derived weights (no autograd) is
    the output with freshly derived ones, bit for bit; while autograd
    records, they are derived afresh, so the gradients reach q_bias, v_bias,
    the logit scale and the CPB MLP and equal those of a direct call."""
    blk = _block(2)
    x = torch.from_numpy(rng.normal(size=(2, 8, 8, 32)).astype(np.float32)).bfloat16()
    with torch.inference_mode():  # derived here, reused outside: not an inference tensor
        blk(x)
    with torch.no_grad():
        assert not blk.fused_params()["bqkv"].is_inference()
        cached = blk(x)
    a = blk.attn

    def direct(t):
        params = dict(blk.fused_params(), bqkv=a.qkv_bias(), logit_scale=a.scale())
        out = swin_block_fusion.fused_swin_block(
            blk._partition(t), params, _fresh_bias(blk), a.n_heads, True)
        return blk._reverse(out, 8, 8)

    with torch.no_grad():
        torch.testing.assert_close(cached, direct(x), rtol=0, atol=0)
    leaves = [a.q_bias, a.v_bias, a.logit_scale, a.cpb_fc1.weight, a.cpb_fc2.weight]
    got = torch.autograd.grad(blk(x).float().sum(), leaves)
    want = torch.autograd.grad(direct(x).float().sum(), leaves)
    for g, w in zip(got, want):
        assert g is not None and g.abs().max() > 0
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_derived_weights_follow_load_flax_params(rng):
    """A SwinV2 backbone run once (filling the cache), then loaded with new
    flax parameters, gives what a backbone loaded with those parameters
    from the start gives, bit for bit: ``load_flax_params`` copies in place,
    which invalidates every derived weight."""
    kw = dict(model_type="swinv2_parity_test", compute_dtype="bfloat16", gelu="tanh",
              pad_to_square=True)
    jax_model = JaxSwin(JaxTimmConfig(cache_enabled=False, **kw), rngs=nnx.Rngs(0))
    first = export_params(jax_model, rng)
    second = export_params(jax_model, rng)
    assert any(not np.array_equal(first[k], second[k]) for k in first)
    x = torch.from_numpy(rng.uniform(size=(2, 64, 64, 3)).astype(np.float32))
    port = SwinV2Backbone(TimmBackboneConfig(**kw)).eval()
    load_flax_params(port, first)
    fresh = SwinV2Backbone(TimmBackboneConfig(**kw)).eval()
    load_flax_params(fresh, second)
    with torch.no_grad():
        before = port(x)
        load_flax_params(port, second)
        after = port(x)
        want = fresh(x)
    assert not torch.equal(before, want)
    torch.testing.assert_close(after, want, rtol=0, atol=0)
