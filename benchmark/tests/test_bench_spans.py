"""The readers of the program's spans (``spans.py`` and the metrics that
call it) on the tiny programs of ``tiny.py``, run under the profiler on
the CPU as a traced run runs them: the settle unit, then the traced units.
The CPU has no card, so the spans time the device on a stand-in event that
reads the host's clock."""

import dataclasses
import time

import pytest
import torch

from benchmark import loops, spans
from benchmark.readings import Context, read
from benchmark.run import _shapes, spec
from benchmark.tests import tiny

TRACED = 2
READERS = {
    "steps": ("dispatch_ms.train", "video_backbone_ms.train", "perceive_ms.train",
              "gps_backbone_ms.train", "backward_ms.train", "optimizer_ms.train"),
    "requests": ("dispatch_ms.serve", "placement_ms.serve", "video_backbone_ms.serve",
                 "perceive_ms.serve", "gps_backbone_ms.serve"),
}
ALL = [(units, name) for units, names in READERS.items() for name in names]


class _HostClockEvent:
    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        self.at = time.perf_counter()

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.at - self.at)


def _traced(kind: str) -> Context:
    from routeformer_torch.utils import profiling

    cfg = tiny.config(kind)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
        mp.setattr(torch.cuda, "is_initialized", lambda: True)
        mp.setattr(torch.cuda, "Event", _HostClockEvent)
        profiling.reset_timing()
        if kind == "swinv2":
            mix, units = tiny.mix("train_b16"), "steps"
            _, optimizer, step = tiny.build_train_f32(cfg, 3, "cpu")
            optimizer.count = mix["epoch"]
            pool = loops.pool_batches(mix, cfg, 3, "cpu")

            def run_one(i):
                step(*pool[i % len(pool)], mix["epoch"])
        else:
            mix, units = tiny.mix("serve_b1"), "requests"
            serving = tiny.build_serve_f32(cfg, 3, "cpu")
            pool = loops.request_pool(mix, cfg, 3, "cpu")

            def run_one(i):
                serving(pool[i % len(pool)])
        mix["trace_units"] = TRACED
        trace, counters = loops._traced(run_one, TRACED, 0, "cpu",
                                        loops.builder(cfg).launch_counters)
        ctx = Context(cfg, mix, units, TRACED, trace, counters, 0.1, _shapes(mix, cfg))
        spans.table(ctx)
        profiling.reset_timing()
    return ctx


@pytest.fixture(scope="module")
def contexts():
    return {"steps": _traced("swinv2"), "requests": _traced("vit")}


def test_every_span_metric_is_declared_for_its_cell():
    declared = {m["name"]: m for m in spec()["per_layer"]}
    cells = {"steps": "swinv2_train_b16", "requests": "dinov2_serve_b1"}
    for units, name in ALL:
        assert declared[name]["workloads"] == [cells[units]]
        assert declared[name]["better"] == "lower"


@pytest.mark.parametrize("units,name", ALL)
def test_a_reader_reads_its_own_kind(contexts, units, name):
    value = read(name, contexts[units])
    assert isinstance(value, float) and value > 0.0


@pytest.mark.parametrize("units,name", ALL)
def test_a_reader_reads_nothing_in_the_other_kind(contexts, units, name):
    other = "requests" if units == "steps" else "steps"
    assert read(name, contexts[other]) is None


@pytest.mark.parametrize("units,name", ALL)
def test_a_reader_wants_the_settle_unit_and_the_traced_units(contexts, units, name):
    ctx = contexts[units]
    for traced in (TRACED - 1, TRACED + 1):
        assert read(name, dataclasses.replace(ctx, traced_units=traced)) is None


@pytest.mark.parametrize("units,name", ALL)
def test_a_reader_reads_nothing_without_spans_or_device_totals(contexts, units, name):
    ctx = contexts[units]
    assert read(name, dataclasses.replace(ctx, cache={"spans": {}})) is None
    host_only = {n: {k: v for k, v in row.items() if not k.startswith("device")}
                 for n, row in ctx.cache["spans"].items()}
    got = read(name, dataclasses.replace(ctx, cache={"spans": host_only}))
    assert (got is None) == (not name.startswith("dispatch_ms"))


def test_the_layers_fit_in_their_unit(contexts):
    """Per unit, the spans' readings fit inside the root's own time."""
    for units, names in READERS.items():
        ctx = contexts[units]
        dispatch = read(names[0], ctx)
        assert all(read(n, ctx) <= dispatch for n in names[1:])
        root = ctx.cache["spans"][spans.ROOTS[units]]
        assert root["count"] == TRACED + 1 and root["self"] <= root["total"]
