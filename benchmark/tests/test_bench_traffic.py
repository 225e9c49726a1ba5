"""The traffic generator: the same seed gives the same clips, another seed
others, at the shapes and dtypes each mix states; every mix names a loop."""

import torch

from benchmark import loops
from benchmark.run import spec
from benchmark.traffic import generator


def _mixes():
    return sorted({w["traffic"] for w in spec()["workloads"]})


def test_every_mix_names_a_loop_and_sizes_its_clips():
    for name in _mixes():
        mix = generator.load(name)
        assert mix["kind"] in loops.KINDS, name
        assert set(mix["frame_hw"]) == set(generator.VIEWS), name
        assert mix["batch"] >= 1 and mix["pool"] >= 1 and mix["trace_units"] >= 1


def test_clips_follow_the_seed_at_the_stated_shapes():
    mix = generator.load("train_b16")
    seed = 2 ** 31 + 12345  # the driver's seeds pass 32 signed bits
    a_in, a_tgt = generator.clips(mix, seed, 2, 40, 30, "cpu")
    b_in, b_tgt = generator.clips(mix, seed, 2, 40, 30, "cpu")
    c_in, _ = generator.clips(mix, seed + 1, 2, 40, 30, "cpu")
    for part, length in ((a_in, 40), (a_tgt, 30)):
        assert part["gps"].shape == (2, length, 2) and part["gps"].dtype == torch.float32
        assert part["gaze"].shape == (2, mix["gaze_len"], 2)
        for view, (h, w) in mix["frame_hw"].items():
            assert part[view].shape == (2, length, h, w, 3) and part[view].dtype == torch.uint8
    for key in a_in:
        assert torch.equal(a_in[key], b_in[key]) and torch.equal(a_tgt[key], b_tgt[key])
        assert not torch.equal(a_in[key], c_in[key]), key


def test_serving_pool_and_sample_follow_the_seed():
    mix = generator.load("serve_b1")
    cfg = {"gps_backbone": {"seq_len": 40, "pred_len": 30}}
    small = dict(mix, pool=2)
    a, b = loops.request_pool(small, cfg, 7, "cpu"), loops.request_pool(small, cfg, 7, "cpu")
    assert len(a) == 2 and a[0]["front_video"].shape == (1, 40, 326, 324, 3)
    assert all(torch.equal(a[i][k], b[i][k]) for i in range(2) for k in a[i])
    picks = loops.sampled(2 ** 31 + 9, 500, mix["checked_requests"])
    assert picks == loops.sampled(2 ** 31 + 9, 500, mix["checked_requests"])
    assert len(set(picks)) == mix["checked_requests"] and max(picks) < 500
    assert picks != loops.sampled(2 ** 31 + 10, 500, mix["checked_requests"])
    assert loops.sampled(3, 2, mix["checked_requests"]) == [0, 1]
