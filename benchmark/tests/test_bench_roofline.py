"""The roofline and MFU arithmetic on known shapes."""

import math

import pytest

from benchmark.readings import Context, reader
from benchmark.roofline import flops, kernels, peaks
from benchmark.tests import tiny
from benchmark.traffic import generator


def test_k1_counts_a_swin_block():
    # one frame at stage 2 of SwinV2-base: 256 tokens of 512 channels, 16 heads
    ops, nbytes = kernels.k1_call(1, 256, 512, 256, 16, 1)
    assert ops == 2 * 256 * 12 * 512 * 512 + 4 * 256 * 256 * 512
    assert nbytes == 2 * 2 * 256 * 512 + 2 * 12 * 512 * 512 + 4 * 16 * 256 * 256


def test_k1_frame_is_the_published_swinv2_base_work():
    v = {"img_size": 256, "patch_size": 4, "embed_dim": 128, "depths": [2, 2, 18, 2],
         "heads": [4, 8, 16, 32], "window": 16}
    stages = kernels.swin_stages(v)
    assert [s[:3] for s in stages] == [(4096, 128, 256), (1024, 256, 256), (256, 512, 256),
                                        (64, 1024, 64)]
    assert stages[0][4] == 16 and stages[2][4] == 1  # window kinds of a shifted block
    assert kernels.k1_frame_flops(v) == pytest.approx(42.71e9, rel=1e-3)  # 42.7 GFLOP a frame


def test_k4_and_k3b_counts():
    ops, nbytes = kernels.k4_call(24, 1369, 12, 64)
    assert ops == 4 * 24 * 12 * 1369 ** 2 * 64
    assert peaks.bound_s(12 * ops, 12 * nbytes) == pytest.approx(1.677e-3, rel=1e-3)
    r, l = 384, 65
    u = 5 * math.ceil(math.log(l))
    ops, _ = kernels.k3b_layer(r, l)
    gemm = 2 * r * l * (4 * 128 * 128 + 2 * 128 * 256)
    assert ops == 3 * gemm + 2 * r * l * l * 128 + 10 * r * u * l * 128


def test_bound_takes_the_slower_of_compute_and_memory():
    assert peaks.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(989e12, 6.7e12) == pytest.approx(2.0)


def test_flops_of_a_request_and_a_step():
    cfg = tiny.config("vit")
    mix = tiny.mix("serve_b1")
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in generator.clips(
        mix, 1, 1, 40, 30, "cpu")[0].items()}
    request = flops.request_flops(cfg, shapes)
    # the ViT's blocks alone: 24 frames of 16 tokens, 2 blocks of width 32
    frames, tokens, width = 24, 16, 32
    vit = frames * 2 * (2 * tokens * 12 * width * width + 4 * tokens * tokens * width)
    assert request > vit
    tmix = tiny.mix("train_b16")
    inp, tgt = generator.clips(tmix, 1, tmix["batch"], 40, 30, "cpu")
    step = flops.train_step_flops(cfg, {k: (tuple(v.shape), v.dtype) for k, v in inp.items()},
                                  {k: (tuple(v.shape), v.dtype) for k, v in tgt.items()}, 12)
    assert step > 2 * request


def test_mfu_reader_divides_by_the_bf16_peak(monkeypatch):
    monkeypatch.setattr(flops, "request_flops", lambda config, shapes: 989e12 * 0.05)
    ctx = Context(tiny.config("vit"), tiny.mix("serve_b1"), "requests", 4, None, {}, 0.1,
                  {"input": {}})
    assert reader("mfu.serve")(ctx) == pytest.approx(50.0)
    assert reader("mfu.train")(ctx) is None  # the other cell's metric reads nothing


def test_per_layer_readers_leave_out_what_they_cannot_read():
    from benchmark.devtrace import Op, Summary

    trace = Summary([Op("dense_attention_kernel", 0.0, 0.5, True, 1)], 1.0, 0.5, [], {})
    cfg = tiny.config("vit")
    ctx = Context(cfg, tiny.mix("serve_b1"), "requests", 2, trace, {"K4": 0}, 0.1, {})
    assert reader("k4_roofline.serve")(ctx) is None  # the counter disagrees with the shapes
    ctx.counters = {"K4": 2 * cfg["video_backbone"]["depth"]}
    assert reader("k4_roofline.serve")(ctx) > 0
    assert reader("idle_share.serve")(ctx) == pytest.approx(50.0)
    assert reader("kernels_per_request.serve")(ctx) == pytest.approx(0.5)
    assert reader("k1_roofline.train")(ctx) is None and reader("k3b_roofline.train")(ctx) is None
