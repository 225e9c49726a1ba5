"""The published flagship's configuration (SwinV2-B with the exact gelu):
its file against the tanh configuration's, its checked training steps
against the plain reference at a tiny size on the CPU, and the reader of
``k1_erf_roofline.train``."""

import json
import time

import pytest
import torch

from benchmark import check, loops
from benchmark.devtrace import Op, Summary
from benchmark.readings import Context, reader
from benchmark.reference.model import Routeformer as Reference
from benchmark.tests import tiny
from benchmark.weights import make_weights

CONFIGS = tiny.HERE / "configs"


def _exact(config: dict) -> dict:
    """A tiny configuration with the exact gelu, as the published file has it."""
    config["video_backbone"]["gelu"] = "exact"
    return config


def test_the_exact_configuration_differs_only_in_its_gelu_and_names():
    tanh = json.loads((CONFIGS / "routeformer_swinv2_tanh.json").read_text())
    exact = json.loads((CONFIGS / "routeformer_swinv2_exact.json").read_text())
    assert exact["video_backbone"]["gelu"] == "exact" and exact["reduced"] == []
    assert exact["name"] == "routeformer_swinv2_exact"
    for key in ("name", "source", "deployment"):
        assert exact.pop(key) != tanh.pop(key)
    exact["video_backbone"]["gelu"] = "tanh"
    assert exact == tanh


def test_exact_training_forward_draws_what_the_program_draws(monkeypatch):
    """The program's training forward (every frozen block on K1's plain path
    with the erf gelu) against the reference, with the same draws."""
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    cfg = _exact(tiny.config("swinv2"))
    model = loops.builder(cfg)._model(cfg, 7, "cpu")
    tiny.float32_backbone(model, cfg)
    ref = Reference(cfg)
    ref.load_state_dict(make_weights(cfg, 7, "cpu"), strict=False)
    inp, _ = loops.pool_batches(tiny.mix("train_b16"), cfg, 7, "cpu")[0]
    model.train(), ref.train()
    for seed in (3, 4):
        torch.manual_seed(seed)
        with torch.no_grad():
            gps, dense = model(inp)
        torch.manual_seed(seed)
        with torch.no_grad():
            want_gps, want_dense = ref(inp, ref.draws("cpu", True), decisions=True)
        assert (gps - want_gps).abs().max() <= 4e-3  # meters, at fixes about 1e4 m out
        assert (dense - want_dense).abs().max() <= 1e-5 * want_dense.abs().max()


def test_exact_checked_training_steps_agree(monkeypatch):
    """The cell's numbers on the float32 program: the frame encoder's output
    (the exact SwinV2 on K1's plain path) within 1e-5, the glue bit for bit,
    the frozen backbone unmoved; the gradients and changes, which a
    ProbSparse selection flipping at a near-tie moves (K1 rounds where the
    reference does not; the tanh configuration's read alike), within 1e-3,
    far inside the cell's limits."""
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    out = loops.train_step(_exact(tiny.config("swinv2")), tiny.mix("train_b16"), 2 ** 31 + 9,
                           0.2, False, "cpu", time.perf_counter(), build=tiny.build_train_f32)
    n = out.numbers
    assert n["frame_gap"] < 1e-5 and n["frozen_moved"] == 0.0 and n["loss_glue_gap"] < 1e-6
    for name in check.limits("swinv2_exact_train_b16"):
        assert n[name] < 1e-3, (name, n[name])


@pytest.mark.parametrize("gelu,k1,reads", [("exact", "full", True), ("tanh", "full", False),
                                           ("exact", "short", False)])
def test_k1_erf_roofline_reads_only_a_full_count_of_exact_blocks(gelu, k1, reads):
    cfg = tiny.config("swinv2")
    cfg["video_backbone"]["gelu"] = gelu
    trace = Summary([Op("gemm_kernel<BiasActEpi>", 0.0, 0.5, True, 1)], 1.0, 0.5, [], {})
    ctx = Context(cfg, tiny.mix("train_b16"), "steps", 2, trace, {}, 0.1, {})
    full = sum(cfg["video_backbone"]["depths"]) * len(ctx.pass_frames()) * ctx.traced_units
    ctx.counters = {"K1": full if k1 == "full" else full - 1}
    value = reader("k1_erf_roofline.train")(ctx)
    assert (value is not None and value > 0) == reads
    assert reader("k1_roofline.train")(ctx) is None or gelu == "tanh"
