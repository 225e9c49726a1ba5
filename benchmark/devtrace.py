"""The device trace of a traced stretch, read from ``torch.profiler``'s
Chrome trace (written under ``TMPDIR`` and deleted once read).

- Device operations are the trace's kernels, copies and sets. Busy time is
  the union of their intervals; the stretch is the span of the benchmark's
  ``bench.unit`` ranges (from the first one's start to the end of the last
  device operation).
- Kernels are grouped by name with ``KERNEL_TAGS``, a frozen copy of the
  labels under which the port's bring-up checks group its kernels (the
  first tag found in a name labels it).
- A kernel is attributed to a host range (for example the fused Perceive
  stack's backward) through the launch that the trace correlates with it.
- The idle gaps are the stretches between merged device intervals, each
  named by the innermost host range or op open at its middle.
"""

import bisect
import contextlib
import dataclasses
import json
import os
import tempfile
from typing import List, Optional

import torch

KERNEL_TAGS = (("BiasActEpi", "K1 gemm"),
               ("residual_layernorm", "K1 residual_layernorm"),
               ("window_attention_kernel", "K2 window_attention"),
               ("dense_attention", "K4 dense_attention"),
               ("gemm_kernel<(anonymous namespace)::Epi", "K3 gemm"),
               ("gemm_kernel<(anonymous namespace)::NormEpi", "K3 gemm"),
               ("gemm_kernel<(anonymous namespace)::FwdEpi", "K3 gemm"),
               ("gemm_f32_kernel", "K3 gemm"),
               ("measure_mma_kernel", "K3 attention"),
               ("measure_fma_kernel", "K3 attention"),
               ("select_kernel", "K3 attention"),
               ("attn_bwd_kernel", "K3 attention"),
               ("layernorm_bwd_kernel", "K3 rows"),
               ("to_bf16_kernel", "K3 rows"),
               ("::layernorm_kernel(", "K3 rows"),
               ("ReduceJobs", "K3 rows"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def label(name: str) -> str:
    return next((lab for tag, lab in KERNEL_TAGS if tag in name), name[:96])


@dataclasses.dataclass
class Op:
    name: str
    start: float  # seconds
    end: float
    kernel: bool
    correlation: Optional[int]


@dataclasses.dataclass
class Summary:
    ops: List[Op]  # device operations in the stretch
    window_s: float
    busy_s: float
    gaps: list  # [(host name, seconds)], longest first
    host_ranges: dict  # name -> correlation ids launched inside such a range

    def kernels(self) -> List[Op]:
        return [o for o in self.ops if o.kernel]

    def seconds_by_label(self) -> dict:
        out = {}
        for o in self.ops:
            key = label(o.name)
            out[key] = out.get(key, 0.0) + (o.end - o.start)
        return out

    def seconds_of(self, tags) -> float:
        return sum(o.end - o.start for o in self.kernels() if label(o.name).split()[0] in tags)

    def seconds_launched_in(self, range_name: str) -> Optional[float]:
        ids = self.host_ranges.get(range_name)
        if not ids:
            return None
        return sum(o.end - o.start for o in self.kernels() if o.correlation in ids)


class _Session:
    trace_path: str = ""


@contextlib.contextmanager
def profiling():
    """Profile host and device; yields a session whose ``trace_path`` is set
    once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    session = _Session()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield session
    prof.export_chrome_trace(path)
    session.trace_path = path


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarise(path: str, ranges=("FusedStackBackward",)) -> Summary:
    """Read and delete the trace at ``path``."""
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = [e for e in events if e.get("ph") == "X"]
    units = [e for e in spans if e.get("name") == "bench.unit"
             and e.get("cat") in ("user_annotation", "cpu_op")]
    start = min(e["ts"] for e in units) * 1e-6 if units else None
    ops = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS and e.get("dur", 0) > 0:
            s = e["ts"] * 1e-6
            if start is None or s >= start:
                ops.append(Op(e["name"], s, s + e["dur"] * 1e-6, e["cat"] == "kernel",
                              (e.get("args") or {}).get("correlation")))
    merged = _merge([(o.start, o.end) for o in ops])
    if start is None:
        start = merged[0][0] if merged else 0.0
    end = max([m[1] for m in merged] + [max((e["ts"] + e["dur"]) * 1e-6 for e in units)
                                        if units else start])
    busy = sum(e - s for s, e in merged)
    host = [e for e in spans if e.get("cat") in HOST_CATS and e.get("name") != "bench.unit"]
    edges = [start] + [x for m in merged for x in m] + [end]
    gaps = sorted(((s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2 * 1e6
        open_ = [h for h in host if h["ts"] <= mid <= h["ts"] + h["dur"]]
        name = min(open_, key=lambda h: h["dur"])["name"] if open_ else "(no host range)"
        named.append((name[:96], e - s))
    by_tid = {}
    for e in spans:
        if e.get("cat") in LAUNCH_CATS:
            by_tid.setdefault(e.get("tid"), []).append((e["ts"], (e.get("args") or {})
                                                        .get("correlation")))
    for launches in by_tid.values():
        launches.sort(key=lambda t: t[0])
    times = {tid: [t for t, _ in launches] for tid, launches in by_tid.items()}
    host_ranges = {}
    for key in ranges:
        ids = set()
        for h in (h for h in host if key in h["name"]):
            launches = by_tid.get(h.get("tid"), [])
            i = bisect.bisect_left(times.get(h.get("tid"), []), h["ts"])
            while i < len(launches) and launches[i][0] <= h["ts"] + h["dur"]:
                ids.add(launches[i][1])
                i += 1
        ids.discard(None)
        host_ranges[key] = ids
    return Summary(ops, end - start, busy, named, host_ranges)
