"""The loops that drive a window, one per traffic ``kind``, and the checks
that follow them. Each returns an ``Outcome``; ``run.py`` reports it.

- ``train_step``: set-up builds the train step and a pool of distinct
  batches on the device, then drives the step through its first
  ``checked_steps`` steps, one pool batch each, with torch's generators
  seeded from the run's seed before each (what the reference needs to
  draw the same masks and samples), and records the loss of each step,
  the first gradient's norms (from Adam's first moment) and its global
  norm before clipping, and the change of every parameter over those
  steps. The window calls the same step back to back on the pool and
  synchronises once at its end.
- ``closed_loop``: set-up builds the serving model and a pool of clips in
  pinned host memory, and serves two warm-up requests. In the window one
  client sends one request at a time; a request is timed from the call
  until its prediction is in host memory, and every answer is kept. Once
  the window has closed, a sample of the finished requests drawn from the
  seed is served again with each stage's inputs and output captured (the
  replay); the window's answers, the replay and the reference's are
  compared (``check.serve_numbers``).

A traced run (``trace``) runs the first half of the window without the
profiler, then profiles ``trace_units`` further steps or requests.
"""

import dataclasses
import gc
import importlib
import time
from typing import Callable, Optional

import numpy as np
import torch

from benchmark import check, devtrace, hoststate
from benchmark.traffic import generator
from benchmark.weights import make_weights


@dataclasses.dataclass
class Outcome:
    setup_s: float
    attempted: int
    failed: int
    metrics: dict  # end-to-end values by name
    units: str  # "steps" or "requests"
    trace: Optional[devtrace.Summary] = None
    unit_s: Optional[float] = None  # untraced wall seconds a unit (traced runs)
    counters: Optional[dict] = None  # launch counter deltas over the traced units
    numbers: Optional[dict] = None  # the compared numbers
    peak_bytes: int = 0
    notes: dict = dataclasses.field(default_factory=dict)
    host: list = dataclasses.field(default_factory=list)  # (when, host state)


class LossInputs:
    """What a training step's loss is taken over: the model's forward
    output and its target pass's visual features (the last
    ``preprocess_batch`` of the step), copied; ``remove`` restores the
    model."""

    def __init__(self, model):
        self.model, self.out, self.target = model, None, None
        self.handle = model.register_forward_hook(self._hook)
        self.preprocess = model.preprocess_batch
        model.preprocess_batch = self._preprocess

    def _hook(self, module, args, out):
        if self.out is None:
            self.out = [t.detach().float().clone() for t in out]

    def _preprocess(self, *args, **kwargs):
        got = self.preprocess(*args, **kwargs)
        self.target = got[1].detach().float().clone()
        return got

    def remove(self):
        self.handle.remove()
        del self.model.preprocess_batch
        return self


class Capture:
    """The tensor arguments and the output of a module's next call (copies);
    ``remove`` takes the hook off the module."""

    def __init__(self, module, inputs=True):
        self.args, self.out, self.inputs = None, None, inputs
        self.handle = module.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        if self.out is None:
            if self.inputs:
                self.args = [a.detach().clone() for a in args if torch.is_tensor(a)]
            self.out = out.detach().float().clone()

    def remove(self):
        self.handle.remove()
        return self


def builder(config: dict):
    return importlib.import_module(f"benchmark.builders.{config['builder']}")


def step_seed(seed: int, i: int) -> int:
    """The generator seed before checked step ``i``."""
    return (int(seed) * 1_000_003 + 7919 * (i + 1)) % (2 ** 63)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _windowed(run_one: Callable, seconds: float, device, host: list):
    """Call ``run_one(i)`` until ``seconds`` have passed; the clock stops
    after the device has finished. Returns (units, elapsed seconds). The
    host's state is sampled into ``host`` just before and just after."""
    _sync(device)
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way
    host.append(("window start", hoststate.sample(device)))
    start = time.perf_counter()
    n = 0
    while time.perf_counter() - start < seconds:
        run_one(n)
        n += 1
    _sync(device)
    elapsed = time.perf_counter() - start
    host.append(("window end", hoststate.sample(device)))
    return n, elapsed


def _traced(run_one: Callable, units: int, first: int, device, counters: Callable):
    """Profile ``units`` calls of ``run_one`` (indices from ``first``) after
    one more that lets the profiler settle and is left out of the stretch."""
    _sync(device)
    with devtrace.profiling() as session:
        run_one(first)
        _sync(device)
        before = counters()
        for i in range(units):
            with torch.profiler.record_function("bench.unit"):
                run_one(first + 1 + i)
        _sync(device)
    after = counters()
    return devtrace.summarise(session.trace_path), {k: after[k] - before[k] for k in after}


# -------------------------------------------------------------- training #


def pool_batches(mix, cfg, seed, device):
    g = cfg["gps_backbone"]
    inp, tgt = generator.clips(mix, seed, mix["pool"] * mix["batch"], g["seq_len"],
                               g["pred_len"], device)
    b = mix["batch"]
    return [(generator.rows(inp, i * b, (i + 1) * b), generator.rows(tgt, i * b, (i + 1) * b))
            for i in range(mix["pool"])]


def train_step(config, mix, seed, seconds, trace, device, t0, build=None,
               counters=None) -> Outcome:
    bld = builder(config)
    build = build or bld.build_train
    counters = counters or bld.launch_counters
    model, optimizer, step = build(config, seed, device)
    optimizer.count = mix["epoch"]  # one update per epoch so far: past warm-up
    pool = pool_batches(mix, config, seed, device)
    epoch = mix["epoch"]
    prog = {"losses": []}
    for i in range(mix["checked_steps"]):
        torch.manual_seed(step_seed(seed, i))
        frame = Capture(model.frame_encoder, inputs=False) if i == 0 else None
        seen = LossInputs(model) if i == 0 else None
        metrics = step(*pool[i % len(pool)], epoch)
        if frame is not None:
            prog["frame"] = frame.remove().out
            prog["loss_of_outputs"] = loss_of_outputs(*seen.remove().out, seen.target,
                                                      pool[0][1], config, epoch)
        prog["losses"].append(float(metrics["total_loss"]))
        if i == 0:
            prog["grad_norm"] = float(metrics["grad_norm"])
            prog["grad_norms"] = {
                n: float(torch.linalg.vector_norm(optimizer.opt.state[p]["exp_avg"]) / 0.1)
                if p in optimizer.opt.state else 0.0
                for n, p in model.named_parameters()}
    w0 = make_weights(config, seed, device)
    with torch.no_grad():
        prog["change_norms"] = {n: float(torch.linalg.vector_norm(p - w0[n]))
                                for n, p in model.named_parameters()}
        prog["frozen_moved"] = max(float((p - w0[n]).abs().max())
                                   for n, p in model.named_parameters()
                                   if "video_backbone" in n)
    del w0
    _sync(device)
    setup_s = time.perf_counter() - t0

    def run_one(i):
        step(*pool[i % len(pool)], epoch)

    out = Outcome(setup_s, 0, 0, {}, "steps")
    if trace:
        n, elapsed = _windowed(run_one, seconds / 2, device, out.host)
        out.unit_s = elapsed / n
        out.trace, out.counters = _traced(run_one, mix["trace_units"], n, device, counters)
        steps = n + 1 + mix["trace_units"]
    else:
        steps, elapsed = _windowed(run_one, seconds, device, out.host)
        out.metrics["train_clips_per_s"] = steps * mix["batch"] / elapsed
    out.attempted = steps * mix["batch"]
    if torch.device(device).type == "cuda":
        out.peak_bytes = torch.cuda.max_memory_allocated()
    del model, optimizer, step, run_one
    _free(device)

    ref = reference_train(config, mix, seed, device, pool, "f32")
    out.numbers = check.train_numbers(prog, ref)
    out.notes["widest"] = {key: check.worst_leaves(prog, ref, key)
                           for key in ("grad_norms", "change_norms")}
    out.notes["left out of the change"] = check.left_out(ref)
    out.notes["losses"] = {"program": prog["losses"], "reference": ref["losses"]}
    return out


def loss_of_outputs(future_gps, future_visual, target_visual, target: dict, config,
                    epoch: int) -> float:
    """The reference's loss of a step's outputs against the batch's
    targets, over every row."""
    from benchmark.reference.train import loss_of

    total, _ = loss_of(future_gps, future_visual, target["gps"],
                       target_visual[:, :future_visual.shape[1]], epoch, config["model"])
    return float(total)


def reference_train(config, mix, seed, device, pool, precision, loss_rows=None,
                    adjust=None) -> dict:
    """The reference (or the control, in ``precision``) through the checked
    steps: losses, the first gradient's global norm before clipping,
    first-gradient and change norms by leaf, the frame encoder's output in
    step 1, the reference's loss of step 1's outputs over every row. ``loss_rows`` takes the loss over
    that many first rows of each batch (a fault); ``adjust(model)`` may
    change the reference model first."""
    from benchmark.reference.train import ReferenceTrainer

    weights = make_weights(config, seed, device)
    ref = ReferenceTrainer(config, weights, device, precision, count=mix["epoch"])
    if adjust is not None:
        adjust(ref.model)
    out = {"losses": []}
    for i in range(mix["checked_steps"]):
        inp, tgt = pool[i % len(pool)]
        frame = Capture(ref.model.frame_encoder, inputs=False) if i == 0 else None
        r = ref.step(inp, tgt, mix["epoch"], step_seed(seed, i), loss_rows)
        if frame is not None:
            out["frame"] = frame.remove().out
        out["losses"].append(r["total_loss"])
        if i == 0:
            out["loss_of_outputs"] = loss_of_outputs(*r["outputs"], tgt, config, mix["epoch"])
            out["grad_norm"] = r["grad_norm"]
            out["grad_norms"] = {n: float(torch.linalg.vector_norm(g))
                                 for n, g in r["grads"].items()}
    with torch.no_grad():
        out["change_norms"] = {n: float(torch.linalg.vector_norm(p - weights[n]))
                               for n, p in ref.model.named_parameters()}
        out["frozen_moved"] = max(float((p - weights[n]).abs().max())
                                  for n, p in ref.model.named_parameters()
                                  if "video_backbone" in n)
    del ref, weights
    _free(device)
    return out


# --------------------------------------------------------------- serving #


def request_pool(mix, cfg, seed, device):
    """``pool`` single-clip requests in pinned host memory (on the CPU,
    plain host memory)."""
    g = cfg["gps_backbone"]
    inp, _ = generator.clips(mix, seed, mix["pool"], g["seq_len"], g["pred_len"], device)
    pin = torch.device(device).type == "cuda"
    out = []
    for i in range(mix["pool"]):
        req = {k: v[i:i + 1].contiguous().cpu() for k, v in inp.items()}
        out.append({k: v.pin_memory() if pin else v for k, v in req.items()})
    return out


def sampled(seed: int, finished: int, k: int) -> list:
    """``k`` request indices drawn from the seed among the finished ones."""
    rng = np.random.default_rng([int(seed), 1])
    return sorted(rng.choice(finished, size=min(k, finished), replace=False).tolist())


STAGES = ("gaze_encoder", "gaze_video_decoder", "video_encoder", "gps_backbone")


def capture(model) -> dict:
    """Captures of the frame encoder's output and of each later stage's
    inputs and output, for one forward of ``model`` (the program's or the
    reference's: their stages share names)."""
    caps = {"frame_encoder": Capture(model.frame_encoder, inputs=False)}
    caps.update({name: Capture(getattr(model, name)) for name in STAGES})
    return caps


def _record(caps: dict, displacement, dense) -> dict:
    rec = {name: c.remove() for name, c in caps.items()}
    rec = {name: (c.args, c.out) for name, c in rec.items()}
    rec.update(displacement=displacement.float().cpu(), dense=dense.float().cpu())
    return rec


def replay(serving, requests) -> list:
    """The program's record of each request (``_record``), served again
    after the window with its stages captured."""
    out = []
    for req in requests:
        caps = capture(serving.model)
        gps, dense = serving(req)
        out.append(_record(caps, gps.cpu() - req["gps"][:, -1:], dense))
    return out


def closed_loop(config, mix, seed, seconds, trace, device, t0, build=None,
                counters=None) -> Outcome:
    bld = builder(config)
    build = build or bld.build_serve
    counters = counters or bld.launch_counters
    serving = build(config, seed, device)
    pool = request_pool(mix, config, seed, device)
    for i in range(2):
        gps, dense = serving(pool[i % len(pool)])
        gps.cpu(), dense.cpu()
    _sync(device)
    setup_s = time.perf_counter() - t0
    latencies, answers = [], []

    def run_one(i):
        req = pool[i % len(pool)]
        start = time.perf_counter()
        gps, dense = serving(req)
        gps, dense = gps.cpu(), dense.cpu()
        latencies.append(time.perf_counter() - start)
        answers.append((i % len(pool), gps, dense))

    out = Outcome(setup_s, 0, 0, {}, "requests")
    if trace:
        n, elapsed = _windowed(run_one, seconds / 2, device, out.host)
        out.unit_s = elapsed / n
        out.trace, out.counters = _traced(run_one, mix["trace_units"], n, device, counters)
    else:
        _windowed(run_one, seconds, device, out.host)
        lat = np.asarray(latencies) * 1e3
        out.metrics["serve_ms_p50"] = float(np.percentile(lat, 50))
        out.metrics["serve_ms_p95"] = float(np.percentile(lat, 95))
        half = len(lat) // 2
        out.notes["p50 by half of the window"] = [float(np.percentile(lat[:half], 50)),
                                                  float(np.percentile(lat[half:], 50))]
    out.attempted = len(answers)
    out.notes["requests"] = len(answers)
    if torch.device(device).type == "cuda":
        out.peak_bytes = torch.cuda.max_memory_allocated()

    picks = sampled(seed, len(answers), mix["checked_requests"])
    requests = [pool[answers[i][0]] for i in picks]
    window = [(answers[i][1] - requests[k]["gps"][:, -1:], answers[i][2].float())
              for k, i in enumerate(picks)]
    with torch.no_grad():
        prog = replay(serving, requests)
    del serving, run_one
    _free(device)

    ref = reference_serve(config, seed, device, requests, "f32")
    stages = reference_stages(config, seed, device, prog)
    glue = reference_glue(config, seed, device, prog, requests)
    out.numbers = check.serve_numbers(window, prog, ref, stages, glue)
    out.notes["checked requests"] = picks
    return out


def _reference_model(config, seed, device, precision, adjust=None):
    from benchmark.reference.model import Routeformer, float32_matmuls

    float32_matmuls()
    model = Routeformer(config, precision, frame_chunk=8).to(device)
    model.load_state_dict(make_weights(config, seed, device), strict=False)
    model.eval()
    return model if adjust is None else adjust(model)


def reference_serve(config, seed, device, requests, precision, adjust=None) -> list:
    """The reference's record of each request, end to end from the request
    (``_record``'s layout); ``adjust(model)`` may change the reference
    model first."""
    model = _reference_model(config, seed, device, precision, adjust)
    out = []
    with torch.no_grad():
        for req in requests:
            req = {k: v.to(device) for k, v in req.items()}
            caps = capture(model)
            gps, dense = model(req, model.draws(device, False), decisions=False)
            out.append(_record(caps, gps - req["gps"][:, -1:].float(), dense))
    del model
    _free(device)
    return out


def reference_stages(config, seed, device, records) -> list:
    """The float32 reference's output of each stage after the frame encoder
    from the inputs that stage got in ``records``, and its displacement
    and dense features from the GPS backbone's input there."""
    model = _reference_model(config, seed, device, "f32")
    draws = model.draws(device, False)
    emb = config["model"]["image_embedding_size"]
    out = []
    with torch.no_grad():
        for rec in records:
            got = {}
            for name in STAGES:
                args = [a.to(device) for a in rec[name][0]]
                got[name] = getattr(model, name)(*args, draws).float()
            head = got["gps_backbone"]
            got["displacement"] = torch.cumsum(head[..., :2], dim=1).cpu()
            got["dense"] = head[..., 2:2 + emb].cpu()
            out.append(got)
    del model
    _free(device)
    return out


def reference_glue(config, seed, device, records, requests) -> list:
    """The float32 reference's own glue between the stages, run on the
    program's stage outputs in ``records``: each stage's inputs as the
    reference's forward builds them from the request and the program's
    earlier stages, and the answer from the program's GPS backbone output."""
    model = _reference_model(config, seed, device, "f32")
    model.video_backbone.forward = lambda frames: torch.zeros(  # its maps feed no one here
        frames.shape[0], 1, 1, 1, device=frames.device)
    out = []
    with torch.no_grad():
        for rec, req in zip(records, requests):
            for name in ("frame_encoder",) + STAGES:
                given = rec[name][1].to(device)
                getattr(model, name).forward = lambda *args, given=given: given
            caps = {name: Capture(getattr(model, name)) for name in STAGES}
            req = {k: v.to(device) for k, v in req.items()}
            future, dense = model(req, model.draws(device, False), decisions=False)
            got = {name: c.remove().args for name, c in caps.items()}
            got.update(displacement=(future - req["gps"][:, -1:].float()).cpu(),
                       dense=dense.float().cpu())
            out.append(got)
    del model
    _free(device)
    return out


KINDS = {"train_step": train_step, "closed_loop": closed_loop}
