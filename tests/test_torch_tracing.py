"""The port's spans (``routeformer_torch/utils/profiling.py``) at its layer
boundaries, on the CPU at tiny sizes: off, a span builds nothing; under
the torch profiler a train step and a served request record their spans
with parents and units, and the trace carries their names; the export
traces none; the timers share the spans' table; the device intervals and
their self times, read lazily, with the pending list bounded."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from routeformer_torch import ExportedModel, ServingModel, export_model
from routeformer_torch.flagship import init_weights
from routeformer_torch.models import Routeformer, RouteformerConfig
from routeformer_torch.models.gps_backbone import GPSBackboneConfig
from routeformer_torch.models.video_backbone import TimmBackboneConfig
from routeformer_torch.optimizers import build_optimizer
from routeformer_torch.parallel import make_train_step
from routeformer_torch.serve import _eval_forward
from routeformer_torch.train import TrainingLosses, routeformer_training_loss
from routeformer_torch.utils import profiling

B, SEQ_LEN, PRED_LEN, GAZE_LEN, IMG = 2, 8, 6, 40, 32
TRAIN_SPANS = ("rf.train_step", "rf.loss", "rf.backward", "rf.optimizer", "rf.video_backbone",
               "rf.perceive.frame", "rf.perceive.gaze", "rf.perceive.gaze_video",
               "rf.perceive.video", "rf.gps_backbone")


@pytest.fixture(autouse=True)
def clean_table(monkeypatch):
    monkeypatch.setattr(profiling, "enabled", False)
    profiling.reset_timing()
    yield
    profiling.reset_timing()


def _model(video: bool = True) -> Routeformer:
    gps = GPSBackboneConfig(seq_len=SEQ_LEN, label_len=SEQ_LEN, pred_len=PRED_LEN, d_model=16,
                            n_heads=4, e_layers=2, d_layers=1, d_ff=32, factor=4, dropout=0.1,
                            activation="relu")
    top = dict(discount_factor={0: 0.97}, epsilon=1.0)
    if video:
        top.update(with_video=True, with_gaze=True, dense_prediction=True, decoder_mode="smart",
                   image_embedding_size=16, encoder_hidden_size=16, encoder_heads=4,
                   encoder_layers=1, encoder_d_ff=32, cross_modal_decoder_heads=4,
                   cross_modal_decoder_layers=1, output_fps=5, video_fps=1, gaze_fps=1,
                   video_backbone_config=TimmBackboneConfig(
                       model_type="swinv2_tiny_test", compute_dtype="float32",
                       cache_enabled=False))
    model = Routeformer(RouteformerConfig(gps_backbone_config=gps, **top))
    init_weights(model, 0)
    return model


def _batch(seed: int, length: int = SEQ_LEN, video: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    out = {"gps": torch.from_numpy(np.cumsum(rng.normal(size=(B, length, 2)), 1)
                                   .astype(np.float32))}
    if video:
        for view in ("left_video", "right_video", "front_video"):
            out[view] = torch.from_numpy(rng.uniform(size=(B, length, IMG, IMG, 3))
                                         .astype(np.float32))
        out["gaze"] = torch.from_numpy(rng.uniform(size=(B, GAZE_LEN, 2)).astype(np.float32))
    return out


def _train_step(model):
    optimizer = build_optimizer(model)
    losses = TrainingLosses.from_config(model.configs)
    return make_train_step(model, optimizer, lambda m, i, t, e: routeformer_training_loss(
        m, i, t, e, losses))


def _rf_names(summary: dict) -> set:
    return {name for name in summary if name.startswith("rf.")}


def test_spans_off_build_no_range_and_no_event(monkeypatch):
    """Tracing off, a train step and a served request construct no
    ``record_function`` and no CUDA event, and record nothing."""
    def refuse(*args, **kwargs):
        raise AssertionError("built while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    model = _model()
    _train_step(model)(_batch(0), _batch(1, PRED_LEN), 12)
    ServingModel(model, torch.device("cpu"))(_batch(2))
    assert profiling.span("rf.train_step") is profiling.span("rf.serve.request")
    assert not _rf_names(profiling.timing_summary()) and not profiling.recent_spans()


def test_train_step_spans_under_the_profiler(tmp_path):
    """Under ``torch.profiler`` one train step records its root once, the
    backbone twice (input and target passes), the loss, backward and
    optimizer as the root's children; self time is within total time, and
    the exported trace holds every span as a user annotation."""
    model = _model()
    step = _train_step(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(_batch(0), _batch(1, PRED_LEN), 12)
    summary = profiling.timing_summary()
    assert _rf_names(summary) == set(TRAIN_SPANS)
    assert summary["rf.train_step"]["count"] == 1 and summary["rf.video_backbone"]["count"] == 2
    for row in summary.values():
        assert 0.0 <= row["self"] <= row["total"] and "device_total" not in row
    spans = profiling.recent_spans()
    parents = {s.name: s.parent.name for s in spans if s.parent is not None}
    assert all(parents[n] == "rf.train_step" for n in ("rf.loss", "rf.backward", "rf.optimizer"))
    assert parents["rf.video_backbone"] == parents["rf.gps_backbone"] == "rf.loss"
    assert len({s.unit for s in spans}) == 1
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(TRAIN_SPANS) <= annotated


def test_serving_spans_with_the_switch_on(monkeypatch):
    """With ``ROUTEFORMER_TRACE`` on, each served request is one unit: its
    root ``rf.serve.request`` with ``rf.place`` and the model's spans inside."""
    monkeypatch.setattr(profiling, "enabled", True)
    serving = ServingModel(_model(), torch.device("cpu"))
    for i in range(3):
        serving(_batch(i))
    summary = profiling.timing_summary()
    assert summary["rf.serve.request"]["count"] == summary["rf.place"]["count"] == 3
    assert summary["rf.video_backbone"]["count"] == 3
    spans = profiling.recent_spans()
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["rf.serve.request"] * 3
    assert len({s.unit for s in roots}) == 3
    for s in spans:
        if s.parent is not None:
            assert s.unit == s.parent.unit
    assert all(s.parent.name == "rf.serve.request" for s in spans if s.name == "rf.place")


def test_the_switch_is_read_at_import():
    """``ROUTEFORMER_TRACE=1`` in the environment turns the spans on."""
    code = "from routeformer_torch.utils import profiling; print(profiling.enabled)"
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "ROUTEFORMER_TRACE": "1"}, check=True)
    assert got.stdout.strip() == "True"


def test_export_with_spans_on_traces_none(monkeypatch):
    """Spans on, the export still traces the forward, carries no profiler
    range, and its answer is the live model's."""
    monkeypatch.setattr(profiling, "enabled", True)
    model = _model(video=False)
    batch = {"gps": _batch(0, video=False)["gps"]}
    data = export_model(model, batch)
    program = torch.export.load(io.BytesIO(data))
    assert "record_function" not in str(program.graph)
    served = ExportedModel(data, _eval_forward(model)[1])
    got = served(batch)
    want = ServingModel(model, torch.device("cpu"))(batch)
    want = want[0] if isinstance(want, tuple) else want
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    summary = profiling.timing_summary()
    assert summary["rf.serve.request"]["count"] == 2 and summary["rf.gps_backbone"]["count"] == 1


def test_timers_and_spans_share_one_table(monkeypatch):
    """``time_it`` and ``TimeIt`` land in the spans' table with host times."""
    monkeypatch.setattr(profiling, "enabled", True)

    @profiling.time_it(name="timed")
    def f():
        with profiling.span("outer"), profiling.span("inner"):
            return sum(range(1000))

    f()
    with profiling.TimeIt("block"):
        f()
    summary = profiling.timing_summary()
    assert set(summary) == {"timed", "block", "outer", "inner"}
    assert summary["timed"]["count"] == 2 and summary["block"]["count"] == 1
    for row in summary.values():
        assert {"count", "total", "mean", "max", "self"} <= set(row)
    assert summary["outer"]["self"] <= summary["outer"]["total"] - summary["inner"]["total"] + 1e-9


class _FakeEvent:
    """A timing event on a clock the test advances."""

    clock = 0.0
    queries = 0

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self):
        self.at = _FakeEvent.clock

    def query(self):
        _FakeEvent.queries += 1
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_device_intervals_read_lazily_and_bounded(monkeypatch):
    """The device total and self time come from the entry and exit events
    (a child's interval taken out of its parent's self time); finished
    intervals are read once more than ``PENDING_LIMIT`` wait."""
    monkeypatch.setattr(profiling, "enabled", True)
    monkeypatch.setattr(profiling, "PENDING_LIMIT", 4)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    for _ in range(10):
        with profiling.span("rf.outer"):
            _FakeEvent.clock += 1.0
            with profiling.span("rf.inner"):
                _FakeEvent.clock += 2.0
        assert len(profiling._PENDING) <= 5
    assert _FakeEvent.queries > 0
    summary = profiling.timing_summary()
    assert not profiling._PENDING
    assert summary["rf.outer"]["device_total"] == pytest.approx(10 * 3e-3)
    assert summary["rf.outer"]["device_self"] == pytest.approx(10 * 1e-3)
    assert summary["rf.inner"]["device_total"] == summary["rf.inner"]["device_self"]
    assert summary["rf.inner"]["device_total"] == pytest.approx(10 * 2e-3)
