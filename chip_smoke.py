#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Require CUDA; print the card's name and power limit (nvidia-smi).
2. Build the kernels from ``routeformer_torch/csrc`` (nvcc, sm_90a).
3. K2 (window attention) against its plain version on the card at the
   flagship's stage-0 and stage-3 shapes and a ragged n = 144.
4. K1 (fused SwinV2 block) against its plain version at the four stage
   geometries, shifted where the model shifts.
5. Flagship serving: build the full-width flagship from a seed on the card,
   save it as a serving bundle, load it back and answer three batch-1 and
   one batch-4 request of synthetic GEM-geometry clips; check shapes,
   finiteness and 24 K1 and 24 K2 launches per forward; hold the card's
   forward against a CPU run of the same weights (plain versions,
   exhaustive ProbSparse); time a request with CUDA events.
6. Print a ``kernels`` JSON line (launches, times, bound, library time).
7. Print ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX. Timings are back-to-back launches (warm L2).
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12   # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
BUNDLE_DIR = ROOT / "build" / "smoke_bundle"

# K1/K2 geometry per flagship forward at batch 1 (24 frames):
# (name, windows, tokens, channels, heads, blocks per forward, window kinds
# of the shifted block or None where the window covers the feature map).
STAGES = [
    ("stage0", 384, 256, 128, 4, 2, 16),
    ("stage1", 96, 256, 256, 8, 2, 4),
    ("stage2", 24, 256, 512, 16, 18, None),
    ("stage3", 24, 64, 1024, 32, 2, None),
]
K2_TOL = 1e-2  # max |kernel - plain| / max(1, max |plain|), bf16 output
K1_TOL = 1e-2  # max |kernel - plain| / max |plain|, bf16 output
FEATURE_TOL = 5e-2  # backbone feature maps, card vs CPU, relative to max
PRED_TOL = 5e-2  # displacement and dense features, card vs CPU, relative to max


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_err(got, want, floor: float = 0.0) -> float:
    err = (got.float() - want.float()).abs().max().item()
    return err / max(floor, want.float().abs().max().item())


# ---------------------------------------------------------------- phase 3 #


def k2_inputs(b, h, n, d, nb, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=g).bfloat16()
               for _ in range(3))
    bias = 16 * torch.sigmoid(torch.randn(nb, h, n, n, device="cuda", generator=g))
    scale = torch.exp(torch.clamp(
        torch.randn(h, device="cuda", generator=g) * 0.5 + 2.3, max=math.log(100.0)))
    return q, k, v, bias.contiguous(), scale.contiguous()


def check_k2(results: dict) -> float:
    from routeformer_torch.ops import flash_attention as fa

    worst = 0.0
    for b, h, n, d, nb in [(384, 4, 256, 32, 16), (24, 32, 64, 32, 1),
                           (384, 4, 144, 32, 16)]:
        q, k, v, bias, scale = k2_inputs(b, h, n, d, nb, seed=n)
        got = fa.flash_window_attention(q, k, v, bias, scale, cosine=True)
        want = fa.flash_window_attention_plain(q, k, v, bias, scale, cosine=True)
        err = rel_err(got, want, floor=1.0)
        worst = max(worst, (got.float() - want.float()).abs().max().item())
        log(f"K2 {(b, h, n, d)} nb={nb}: max|kernel-plain|/max(1,|plain|) = {err:.3e}")
        if not err <= K2_TOL:
            raise AssertionError(f"K2 disagrees with its plain version: {err} > {K2_TOL}")
    results["k2_max_abs_err"] = worst
    return worst


# ---------------------------------------------------------------- phase 4 #


def k1_inputs(b, n, c, h, nw, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, s=0.15):
        return torch.randn(*shape, device="cuda", generator=g) * s

    params = {
        "wqkv": rnd(3 * c, c, s=c ** -0.5), "bqkv": rnd(3 * c),
        "wproj": rnd(c, c, s=c ** -0.5), "bproj": rnd(c),
        "ln1_scale": 1 + rnd(c, s=0.05), "ln1_bias": rnd(c, s=0.05),
        "wfc1": rnd(4 * c, c, s=c ** -0.5), "bfc1": rnd(4 * c),
        "wfc2": rnd(c, 4 * c, s=(4 * c) ** -0.5), "bfc2": rnd(c),
        "ln2_scale": 1 + rnd(c, s=0.05), "ln2_bias": rnd(c, s=0.05),
        "logit_scale": torch.exp(torch.clamp(rnd(h, s=0.5) + 2.3, max=math.log(100.0))),
    }
    x = torch.randn(b, n, c, device="cuda", generator=g).bfloat16()
    bias = 16 * torch.sigmoid(rnd(h, n, n, s=1.0))
    if nw is not None:  # shifted block: CPB bias + a -100 mask per window kind
        mask = torch.where(torch.rand(nw, n, n, device="cuda", generator=g) < 0.2,
                           -100.0, 0.0)
        bias = bias[None] + mask[:, None]
    return x, params, bias.contiguous()


def check_k1(results: dict) -> float:
    from routeformer_torch.ops import swin_block_fusion as sbf

    worst = 0.0
    for name, b, n, c, h, _, nw in STAGES:
        for kinds in ([None, nw] if nw else [None]):
            x, params, bias = k1_inputs(b, n, c, h, kinds, seed=c + (kinds or 0))
            got = sbf.fused_swin_block(x, params, bias, h, True)
            want = sbf.fused_swin_block_plain(x, params, bias, h, True)
            err = rel_err(got, want)
            worst = max(worst, (got.float() - want.float()).abs().max().item())
            log(f"K1 {name} {(b, n, c)} H={h} kinds={kinds or 1}: "
                f"max|kernel-plain|/max|plain| = {err:.3e}")
            if not err <= K1_TOL:
                raise AssertionError(f"K1 disagrees with its plain version: {err} > {K1_TOL}")
    results["k1_max_abs_err"] = worst
    return worst


# ---------------------------------------------------------------- phase 5 #


def set_exhaustive(model) -> None:
    """Every ProbSparse layer selects all queries (u == L): the output then
    does not depend on which keys were sampled."""
    from routeformer_torch.models.layers import ProbAttention

    for m in model.modules():
        if isinstance(m, ProbAttention):
            m.factor = 10 ** 6


def serve_flagship(results: dict) -> dict:
    import numpy as np
    import torch

    import routeformer_torch as rt
    from routeformer_torch.io.synthetic import synthetic_batch_numpy
    from routeformer_torch.ops import flash_attention, swin_block_fusion

    t0 = time.perf_counter()
    model = rt.build_flagship(seed=0)  # CUDA by default
    n_params = sum(p.numel() for p in model.parameters())
    rt.save_serving_bundle(BUNDLE_DIR, model)
    cfg = model.configs
    del model
    serving = rt.load_serving_bundle(BUNDLE_DIR)
    shutil.rmtree(BUNDLE_DIR)
    log(f"flagship built, saved and reloaded: {n_params} parameters, "
        f"{time.perf_counter() - t0:.1f} s")

    g = cfg.gps_backbone_config

    def request(seed, batch_size):
        return synthetic_batch_numpy(
            seed, batch_size, seq_len=g.seq_len, pred_len=g.pred_len,
            fps=cfg.output_fps, with_video=True, with_gaze=True,
            frame_hw=(54, 96))["train"]

    requests = [request(1, 1), request(2, 1), request(3, 1), request(4, 4)]

    # The main path: counts set to 0 just before, read just after.
    swin_block_fusion.launches = 0
    flash_attention.launches = 0
    outs = []
    for batch in requests:
        k1_before, k2_before = swin_block_fusion.launches, flash_attention.launches
        gps, dense = serving(batch)
        torch.cuda.synchronize()
        b = batch["gps"].shape[0]
        assert gps.shape == (b, g.pred_len, 2), gps.shape
        assert dense.shape == (b, g.pred_len, cfg.image_embedding_size), dense.shape
        assert torch.isfinite(gps).all() and torch.isfinite(dense).all()
        per = (swin_block_fusion.launches - k1_before, flash_attention.launches - k2_before)
        assert per == (24, 24), f"K1/K2 launches per forward {per}, expected (24, 24)"
        outs.append((gps, dense))
    launches = {"K1": swin_block_fusion.launches, "K2": flash_attention.launches}
    log(f"served 3 x batch 1 and 1 x batch 4: shapes ok, finite, launches {launches}")

    # Time per request after warm-up, and peak memory.
    timing = {}
    for b, batch in ((1, requests[0]), (4, requests[3])):
        torch.cuda.reset_peak_memory_stats()
        timing[b] = cuda_ms(lambda: serving(batch), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"request batch {b}: {timing[b]:.2f} ms, peak memory {peak:.2f} GiB")
        results[f"request_ms_b{b}"] = timing[b]
        results[f"peak_gib_b{b}"] = peak

    profile_request(serving, requests[0], results)

    # Card vs CPU (plain versions) from the same weights, exhaustive ProbSparse.
    torch.set_num_threads(os.cpu_count() or 1)
    cpu_model = rt.models.Routeformer(cfg)
    cpu_model.load_state_dict(serving.model.state_dict())
    cpu_model.eval()
    set_exhaustive(cpu_model)
    set_exhaustive(serving.model)
    feats = {}

    def capture(key):
        def hook(_module, _inp, out):
            feats[key] = out.detach().float().cpu()
        return hook

    h_gpu = serving.model.video_backbone.final_norm.register_forward_hook(capture("gpu"))
    h_cpu = cpu_model.video_backbone.final_norm.register_forward_hook(capture("cpu"))
    batch = requests[0]
    gps_gpu, dense_gpu = serving(batch)
    t0 = time.perf_counter()
    with torch.inference_mode():
        gps_cpu, dense_cpu = cpu_model({k: torch.from_numpy(v) for k, v in batch.items()})
    log(f"CPU reference forward (batch 1): {time.perf_counter() - t0:.1f} s")
    h_gpu.remove()
    h_cpu.remove()
    last = torch.from_numpy(batch["gps"][:, -1:])
    errs = {
        "features": rel_err(feats["gpu"], feats["cpu"]),
        "displacement": rel_err(gps_gpu.cpu() - last, gps_cpu - last),
        "dense": rel_err(dense_gpu.cpu(), dense_cpu),
    }
    log("card vs CPU, max|diff|/max|cpu|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert errs["features"] <= FEATURE_TOL, errs
    assert errs["displacement"] <= PRED_TOL and errs["dense"] <= PRED_TOL, errs
    results["card_vs_cpu"] = errs
    assert np.isfinite(list(errs.values())).all()
    return launches


def profile_request(serving, batch, results: dict) -> None:
    """Device time by kernel over two batch-1 requests (torch.profiler),
    and the device's idle share of the request time measured with CUDA
    events (the profiler's own host overhead is left out of both)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reps = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            serving(batch)
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type != DeviceType.CUDA or t <= 0:
            continue  # device-side events only (CPU ops would count twice)
        name = e.key
        for tag, label in (("gemm_bias_act", "K1 gemm_bias_act"),
                           ("residual_layernorm", "K1 residual_layernorm"),
                           ("window_attention_kernel", "K2 window_attention")):
            if tag in name:
                name = label
        groups[name] = groups.get(name, 0.0) + t / reps / 1e3
    busy = sum(groups.values())
    request_ms = results["request_ms_b1"]
    top = sorted(groups.items(), key=lambda kv: -kv[1])[:10]
    prof_line = {
        "device_busy_ms_per_request": busy,
        "request_ms": request_ms,
        "idle_share": 1 - busy / request_ms if busy else None,
        "kernels_per_request": sum(
            e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
        ) / reps,
        "top_device_ms_per_request": {k[:80]: v for k, v in top},
    }
    results["profile"] = prof_line
    log("profile: " + json.dumps(prof_line))


# ---------------------------------------------------------------- phase 6 #


def kernel_line(launches: dict, results: dict) -> dict:
    import torch
    import torch.nn.functional as F

    from routeformer_torch.ops import flash_attention as fa
    from routeformer_torch.ops import swin_block_fusion as sbf

    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "ops_s": 0.0, "bytes_s": 0.0}
    k2 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
          "ops_s": 0.0, "bytes_s": 0.0}
    for name, b, n, c, h, count, nw in STAGES:
        d = c // h
        # K1 at this geometry (the unshifted bias; a shifted block differs
        # only in its bias's window kinds).
        x, params, bias = k1_inputs(b, n, c, h, None, seed=1)
        t = cuda_ms(lambda: sbf.fused_swin_block(x, params, bias, h, True))
        tp = cuda_ms(lambda: sbf.fused_swin_block_plain(x, params, bias, h, True),
                     iters=3, warmup=1)
        flops = 2 * b * n * (12 * c * c + 2 * n * c)
        nbytes = 2 * b * n * c * 2 + 12 * c * c * 2 + 13 * c * 4 + h * n * n * 4 + h * 4
        bt, _ = bound_ms(flops, nbytes)
        k1["ms"] += count * t
        k1["plain_ms"] += count * tp
        k1["bound_ms"] += count * bt
        k1["ops_s"] += count * flops / PEAK_BF16
        k1["bytes_s"] += count * nbytes / PEAK_BYTES
        log(f"K1 {name}: {t:.3f} ms (plain {tp:.3f}, bound {bt:.4f}) x {count}")

        # K2 at this geometry, bf16 (B, H, n, d) through its wrapper.
        q, k, v, wb, scale = k2_inputs(b, h, n, d, 1, seed=2)
        t = cuda_ms(lambda: fa.flash_window_attention(q, k, v, wb, scale, cosine=True))
        tp = cuda_ms(lambda: fa.flash_window_attention_plain(q, k, v, wb, scale, cosine=True),
                     iters=3, warmup=1)
        qn = (fa._normalise(q.float()) * scale.view(1, h, 1, 1)).bfloat16()
        kn = fa._normalise(k.float()).bfloat16()
        mask = wb.bfloat16()

        def lib():
            return F.scaled_dot_product_attention(qn, kn, v, attn_mask=mask, scale=1.0)

        tl = cuda_ms(lib)
        flops = 4 * b * h * n * n * d
        nbytes = 4 * b * h * n * d * 2 + h * n * n * 4 + h * 4
        bt, _ = bound_ms(flops, nbytes)
        k2["ms"] += count * t
        k2["plain_ms"] += count * tp
        k2["library_ms"] += count * tl
        k2["bound_ms"] += count * bt
        k2["ops_s"] += count * flops / PEAK_BF16
        k2["bytes_s"] += count * nbytes / PEAK_BYTES
        log(f"K2 {name}: {t:.3f} ms (plain {tp:.3f}, sdpa {tl:.3f}, bound {bt:.4f}) x {count}")
        del x, params, bias, q, k, v, wb, scale, qn, kn, mask
        torch.cuda.empty_cache()

    def entry(name, source, replaces, acc, err, library_ms):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": acc["ms"], "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": "operations" if acc["ops_s"] >= acc["bytes_s"] else "bytes",
            "library_ms": library_ms,
        }

    return {"kernels": [
        entry("K1", "routeformer_torch/csrc/swin_block.cu",
              "routeformer_tpu/ops/swin_block_fusion.py:57", k1,
              results["k1_max_abs_err"], None),
        entry("K2", "routeformer_torch/csrc/window_attention.cu",
              "routeformer_tpu/ops/flash_attention.py:120", k2,
              results["k2_max_abs_err"], k2["library_ms"]),
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from routeformer_torch.ops import cuda_build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False  # f32 convs in full f32 (Informer)
    torch.backends.cuda.matmul.allow_tf32 = False

    cuda_build.libraries()
    log(f"kernels built in {cuda_build.build_info['seconds']:.1f} s")
    for name, text in cuda_build.build_info["ptxas"].items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    results = {}
    check_k2(results)
    check_k1(results)
    launches = serve_flagship(results)
    line = kernel_line(launches, results)
    log(f"results: {json.dumps(results)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
