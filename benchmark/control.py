"""The readings that the limits are set from, beside the program's own
(which the benchmark's runs print): the control and the faults, each put
in the program's place and compared with the float32 reference exactly as
a run compares the program.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--variants control,half]

Variants:

- ``control``: the reference in the precision below the configuration's
  (``reference.model.Precision("control")``);
- ``witness``: the float32 reference with its video backbone's features
  moved by a relative 2^-8 of seeded noise (about half a bfloat16 ulp),
  which shows how far the model itself moves under rounding;
- ``half`` (training): the reference's forward on the whole batch, its
  loss taken over the first half of the rows alone;
- ``altered`` (serving): each answer's first displacement step moved by
  one meter where it is produced (the GPS backbone's output, the
  integration and its glue left as the reference computes them).

A state left unchanged reads 1 on ``change_gap`` by its definition and
needs no run. Nothing here runs in the benchmark's own runs.
"""

import argparse
import json
import os
import sys
import time

import torch

from benchmark import check, loops
from benchmark.reference.model import Routeformer
from benchmark.run import ROOT, spec
from benchmark.traffic import generator

WITNESS_NOISE = 2.0 ** -8


def _noisy(model: Routeformer, seed: int) -> Routeformer:
    """Move the backbone's features by a relative WITNESS_NOISE, drawn from
    a generator of its own (the default generators stay untouched)."""
    backbone = model.video_backbone
    forward = backbone.forward
    gen = {}

    def noisy(frames):
        feats = forward(frames)
        g = gen.setdefault(feats.device, torch.Generator(device=feats.device).manual_seed(seed))
        return feats * (1.0 + WITNESS_NOISE * torch.randn(feats.shape, generator=g,
                                                            device=feats.device))

    backbone.forward = noisy
    return model


def train_readings(config, mix, seed, device, variants) -> dict:
    pool = loops.pool_batches(mix, config, seed, device)
    ref = loops.reference_train(config, mix, seed, device, pool, "f32")
    out = {}
    for variant in variants:
        got = loops.reference_train(
            config, mix, seed, device, pool, "control" if variant == "control" else "f32",
            loss_rows=mix["batch"] // 2 if variant == "half" else None,
            adjust=(lambda m: _noisy(m, seed)) if variant == "witness" else None)
        out[variant] = check.train_numbers(got, ref)
        out[variant + " widest"] = {k: check.worst_leaves(got, ref, k, 3)
                                    for k in ("grad_norms", "change_norms")}
    return out


def serve_readings(config, mix, seed, device, variants) -> dict:
    """The variants in the program's place: their answers stand for the
    window's and for the replay's, their stages for the replay's."""
    pool = loops.request_pool(mix, config, seed, device)
    picks = loops.sampled(seed, len(pool), mix["checked_requests"])
    requests = [pool[i] for i in picks]
    ref = loops.reference_serve(config, seed, device, requests, "f32")
    out = {}
    for variant in variants:
        if variant == "witness":
            got = loops.reference_serve(config, seed, device, requests, "f32",
                                        adjust=lambda m: _noisy(m, seed))
        elif variant == "altered":
            got = [dict(r, displacement=r["displacement"].clone()) for r in ref]
            for r in got:
                r["displacement"][:, 0] += 1.0
        else:
            got = loops.reference_serve(config, seed, device, requests, "control")
        stages = loops.reference_stages(config, seed, device, got)
        glue = loops.reference_glue(config, seed, device, got, requests)
        answers = [(r["displacement"], r["dense"]) for r in got]
        out[variant] = check.serve_numbers(answers, got, ref, stages, glue)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--variants", default="control,witness")
    args = parser.parse_args(argv)
    bench = spec()
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    mix = generator.load(cell["traffic"])
    os.environ.update(config.get("env", {}))
    readings = train_readings if mix["kind"] == "train_step" else serve_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        out = readings(config, mix, seed, "cuda", args.variants.split(","))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - start, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
