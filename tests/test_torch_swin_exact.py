"""K1 with the exact (erf) gelu on the CPU: the epilogue's plain version,
the fused block's plain version against the port's unfused exact block,
which blocks take K1, and a tiny exact SwinV2 against the benchmark's plain
reference. Imports no JAX.

The tanh gelu differs from the exact one by up to 4.7e-4 (at x near -2.7
and 2.7), so each tolerance here is one that putting the tanh gelu in the
erf's place fails; the tests assert that it does.
"""

import pytest
import torch
import torch.nn.functional as F

from routeformer_torch.models.video_backbone import swin
from routeformer_torch.models.video_backbone import SwinV2Backbone, TimmBackboneConfig
from routeformer_torch.ops import swin_block_fusion as sbf

GELU_GAP = 2e-5  # of the largest output: f32 sums in another order, far below 4.7e-4


def _max_gap(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


@pytest.mark.parametrize("act,passes", [(sbf.ACT_ERF, True), (sbf.ACT_TANH, False)])
def test_plain_erf_epilogue_is_the_exact_gelu(act, passes):
    """``gemm_bias_act_plain`` with the erf epilogue against ``F.gelu`` in
    float64 on pre-activations over [-4, 4]: within 1e-6 absolute (one f32
    rounding of values up to 4). The tanh epilogue misses by 4.7e-4."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 32, generator=g).bfloat16()
    w = (torch.randn(48, 32, generator=g) * 32 ** -0.5).bfloat16()
    pre = a.double() @ w.double().T
    bias = (4 * torch.rand(48, generator=g, dtype=torch.float64) - 2).float()
    pre = pre + bias.double()
    pre_spread = pre.abs().max().item()
    got = sbf.gemm_bias_act_plain(a, w, bias, act, torch.float32)
    gap = (got.double() - F.gelu(pre)).abs().max().item()
    assert 2.5 < pre_spread < 6  # the range where the two gelus part
    assert (gap <= 1e-6) == passes, gap


def _exact_block(c=32, heads=2, window=4, seed=0):
    """A seeded f32 exact-gelu block on one window a frame, with fc1 sized
    so that its pre-activations spread over about +-3."""
    torch.manual_seed(seed)
    blk = swin.SwinBlock(c, heads, window, 0, (window, window), None, gelu_approximate=False)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if p.ndim == 2:
                p.normal_(0, p.shape[1] ** -0.5)
            elif "norm" not in name and name != "attn.logit_scale":
                p.normal_(0, 0.1)
        blk.fc1.weight.mul_(0.6)
    return blk


@pytest.mark.parametrize("gelu,passes", [("exact", True), ("tanh", False)])
def test_fused_plain_block_matches_the_unfused_exact_block(gelu, passes):
    """``fused_swin_block_plain`` in f32 with the erf gelu against the port's
    unfused exact block (trainable weights under autograd, so the block
    runs unfused) on the same weights: within 2e-5 of the largest output.
    The tanh gelu, whose gap to erf reaches 4.7e-4 at x near -2.7, fails."""
    blk = _exact_block()
    x = torch.randn(6, 4, 4, 32, generator=torch.Generator().manual_seed(1))
    pre = []
    blk.fc1.register_forward_hook(lambda m, i, o: pre.append(o.detach()))
    want = blk(x)
    assert want.requires_grad and len(pre) == 1  # the unfused block, with autograd
    assert 2.5 < pre[0].abs().max().item() < 4.5  # where the two gelus part
    with torch.no_grad():
        got = sbf.fused_swin_block_plain(x.reshape(6, 16, 32), blk.fused_params(),
                                         blk.fused_bias(), 2, compute_bf16=False, gelu=gelu)
    assert (_max_gap(got.reshape(6, 4, 4, 32), want.detach()) <= GELU_GAP) == passes


@pytest.mark.parametrize("case,fused", [("no_grad", True), ("frozen", True),
                                        ("trainable", False), ("input_grad", False),
                                        ("held", False)])
def test_exact_blocks_take_k1_unless_differentiated(monkeypatch, case, fused):
    """An exact bf16 block calls ``fused_swin_block`` (K1, erf epilogue)
    under ``no_grad`` and with frozen weights and an input that needs no
    gradient; with trainable weights, or an input that needs a gradient,
    it runs the unfused block, and under ``no_grad`` too once
    ``swin.hold_unfused`` holds it there."""
    calls = []

    def recording(*args):
        calls.append(args[5])  # the gelu
        return sbf.fused_swin_block(*args)

    monkeypatch.setattr(swin, "fused_swin_block", recording)
    blk = swin.SwinBlock(32, 2, 4, 2, (8, 8), torch.bfloat16, gelu_approximate=False)
    x = torch.randn(2, 8, 8, 32).bfloat16()
    if case in ("frozen", "input_grad"):
        blk.requires_grad_(False)
    if case == "input_grad":
        x.requires_grad_(True)
    if case == "held":
        swin.hold_unfused(blk)
    with torch.set_grad_enabled(case not in ("no_grad", "held")):
        out = blk(x)
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    assert calls == (["exact"] if fused else [])


@pytest.mark.parametrize("gelu,passes", [("exact", True), ("tanh", False)])
def test_tiny_exact_swinv2_matches_the_reference(monkeypatch, gelu, passes):
    """A tiny exact-gelu SwinV2 in f32 under ``no_grad`` (every block on
    K1's plain path) against the benchmark's plain reference on the same
    seeded weights: features within 2e-5 of their largest. K1 with the tanh
    gelu in the erf's place fails."""
    from benchmark.reference import model as reference

    if gelu == "tanh":  # the substitution this configuration exists to avoid
        monkeypatch.setitem(sbf.GELU_ACT, "exact", sbf.ACT_TANH)
    v = {"img_size": 32, "patch_size": 4, "embed_dim": 16, "depths": [2, 2], "heads": [2, 4],
         "window": 4, "gelu": "exact"}
    torch.manual_seed(3)
    port = SwinV2Backbone(TimmBackboneConfig(model_type="swinv2_tiny_test", gelu="exact",
                                             compute_dtype="float32")).eval()
    ref = reference.SwinV2(v, reference.Precision("f32"))
    params = dict(port.named_parameters())
    assert set(params) == {n for n, _ in ref.named_parameters()}
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape) * 1.5 / p[0].numel() ** 0.5)
            elif "norm" not in name and not name.endswith("logit_scale"):
                p.copy_(0.1 * torch.randn(p.shape))
            else:
                p.copy_(params[name])
            params[name].copy_(p)
    frames = torch.randint(0, 256, (3, 30, 28, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    calls = []
    monkeypatch.setattr(swin, "fused_swin_block",
                        lambda *a, **k: calls.append(1) or sbf.fused_swin_block(*a, **k))
    with torch.no_grad():
        got = port.encode_frames(reference.condition_frames(frames, v["img_size"]))
        want = ref(frames)
    assert len(calls) == sum(v["depths"])
    assert (_max_gap(got, want) <= GELU_GAP) == passes
