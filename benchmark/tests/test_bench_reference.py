"""The plain reference against the port's own plain path at a tiny size on
the CPU (the fused Perceive stacks run their plain versions here; the
video backbones run in float32 on both sides): a training forward with its
dropout, view and gaze decisions and ProbSparse samples drawn alike, the
three checked steps, and the served forward stage by stage."""

import time

import torch

from benchmark import check, loops
from benchmark.reference.model import Routeformer as Reference
from benchmark.tests import tiny
from benchmark.weights import make_weights


def test_training_forward_draws_what_the_program_draws(monkeypatch):
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    cfg = tiny.config("swinv2")
    model = loops.builder(cfg)._model(cfg, 7, "cpu")
    tiny.float32_backbone(model, cfg)
    ref = Reference(cfg)
    ref.load_state_dict(make_weights(cfg, 7, "cpu"), strict=False)
    inp, _ = loops.pool_batches(tiny.mix("train_b16"), cfg, 7, "cpu")[0]
    model.train(), ref.train()
    for seed in (3, 4, 5):
        torch.manual_seed(seed)
        with torch.no_grad():
            gps, dense = model(inp)
        torch.manual_seed(seed)
        with torch.no_grad():
            want_gps, want_dense = ref(inp, ref.draws("cpu", True), decisions=True)
        assert (gps - want_gps).abs().max() <= 4e-3  # meters, at fixes about 1e4 m out
        assert (dense - want_dense).abs().max() <= 1e-5 * want_dense.abs().max()


def test_checked_training_steps_agree(monkeypatch):
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    out = loops.train_step(tiny.config("swinv2"), tiny.mix("train_b16"), 2 ** 31 + 5, 0.2,
                           False, "cpu", time.perf_counter(), build=tiny.build_train_f32)
    n = out.numbers
    assert n["loss_gap"] < 1e-5 and n["frame_gap"] < 1e-5 and n["frozen_moved"] == 0.0
    assert n["grad_gap_median"] < 1e-4 and n["change_gap_median"] < 1e-2
    assert n["grad_norm_gap"] < 1e-4 and n["loss_glue_gap"] < 1e-6


def test_served_requests_agree_stage_by_stage(monkeypatch):
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    out = loops.closed_loop(tiny.config("vit"), tiny.mix("serve_b1"), 12345, 2.0, False,
                            "cpu", time.perf_counter(), build=tiny.build_serve_f32)
    assert len(out.notes["checked requests"]) == tiny.mix("serve_b1")["checked_requests"]
    # the numbers the cell holds; the widest gaps may move by a ProbSparse
    # flip at a near-tie even between two float32 computations
    for name in check.limits("dinov2_serve_b1"):
        assert out.numbers[name] < 1e-3, (name, out.numbers[name])
