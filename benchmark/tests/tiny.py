"""Tiny versions of the benchmark's configurations and mixes for the CPU
tests: every key of the real files, at widths a test run can hold."""

import copy
import json
from pathlib import Path

from benchmark import loops
from benchmark.reference import model as reference
from benchmark.traffic import generator

HERE = Path(__file__).resolve().parents[1]
FRAME_HW = {"left_video": [24, 20], "right_video": [24, 20], "front_video": [30, 28]}


def config(kind: str = "swinv2") -> dict:
    name = "routeformer_swinv2_tanh" if kind == "swinv2" else "routeformer_dinov2"
    c = json.loads((HERE / "configs" / f"{name}.json").read_text())
    c["model"].update(compute_dtype="float32", encoder_layers=2)
    c["gps_backbone"].update(d_model=32, n_heads=4, e_layers=3, d_ff=64)
    if kind == "swinv2":
        c["video_backbone"].update(model_type="swinv2_tiny_test", img_size=32, patch_size=4,
                                   embed_dim=16, depths=[2, 2], heads=[2, 4], window=4)
    else:
        c["video_backbone"].update(model_type="vit_tiny_test", img_size=64, patch_size=16,
                                   width=32, depth=2, heads=4)
    return c


def mix(name: str) -> dict:
    m = copy.deepcopy(generator.load(name))
    m["frame_hw"] = FRAME_HW
    if m["kind"] == "train_step":
        m.update(batch=2, pool=3)
    else:
        m.update(pool=4, checked_requests=3)
    return m


def float32_backbone(model, config: dict):
    """Run the program's video backbone in float32 on frames conditioned as
    the reference conditions them (the port conditions uint8 frames in
    float16, which its bfloat16 backbones take): both sides then compute
    in float32 throughout."""
    backbone = model.video_backbone
    for m in backbone.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = None
    size = config["video_backbone"]["img_size"]
    backbone.preprocess_frames = lambda frames: reference.condition_frames(frames, size)
    return model


def build_train_f32(cfg, seed, device):
    model, optimizer, step = loops.builder(cfg).build_train(cfg, seed, device)
    float32_backbone(model, cfg)
    return model, optimizer, step


def build_serve_f32(cfg, seed, device):
    serving = loops.builder(cfg).build_serve(cfg, seed, device)
    float32_backbone(serving.model, cfg)
    return serving
