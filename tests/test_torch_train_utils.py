"""The port's metric buckets against the JAX package's, and its logging,
metric stream and timing helpers, on the CPU."""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from routeformer_tpu.train.metrics import DREYEVE_QUARTILES as JAX_DREYEVE
from routeformer_tpu.train.metrics import GEM_QUARTILES as JAX_GEM
from routeformer_tpu.train.metrics import bucketed_eval_metrics as jax_bucketed
from routeformer_torch.train.logging import MetricsLogger
from routeformer_torch.train.metrics import (
    DREYEVE_QUARTILES,
    GEM_QUARTILES,
    bucketed_eval_metrics,
)
from routeformer_torch.utils import profiling
from routeformer_torch.utils.logging import get_logger, set_logger_config
from test_torch_trainer import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("quartiles", ["gem", "dreyeve"])
def test_bucketed_metrics_match_jax(rng, quartiles):
    """Every bucket and both bucket means, f32 at 1e-6 relative; PCIs on
    the cutoffs fall in no bucket, as in the JAX package; empty buckets
    give 0."""
    port_q, jax_q = {"gem": (GEM_QUARTILES, JAX_GEM),
                     "dreyeve": (DREYEVE_QUARTILES, JAX_DREYEVE)}[quartiles]
    assert port_q == jax_q
    pcis = np.concatenate([rng.uniform(0, 100, 29), [20.0, 40.0, port_q["50%"]]])
    pcis = pcis.astype(np.float32)
    values = [rng.uniform(0, 5, pcis.shape).astype(np.float32) for _ in range(3)]
    got = bucketed_eval_metrics("val_m", pcis, *values, port_q)
    want = jax_bucketed("val_m", jnp.asarray(pcis), *map(jnp.asarray, values), jax_q)
    assert set(got) == set(want) and len(got) == 3 + 2 * 6 * 3
    for k, v in want.items():
        assert got[k].item() == pytest.approx(float(v), rel=1e-6, abs=1e-7), k
    empty = bucketed_eval_metrics("v", np.full(4, 30.0, np.float32), *[v[:4] for v in values],
                                  port_q)
    assert empty["v_ade_>80i"].item() == 0.0


def test_metrics_logger_writes_json_lines(tmp_path):
    log = MetricsLogger(tmp_path, experiment="exp", config={"a": 1})
    log.log({"loss": torch.tensor(2.5), "ade": 1.0}, step=3)
    log.log({"val_ade": np.float32(0.5)}, step=0, split="val")
    log.close()
    records = [json.loads(line) for line in (tmp_path / "exp.metrics.jsonl").read_text()
               .splitlines()]
    assert [(r["step"], r["split"]) for r in records] == [(3, "train"), (0, "val")]
    assert records[0]["loss"] == 2.5 and records[1]["val_ade"] == 0.5
    assert json.loads((tmp_path / "exp.config.json").read_text()) == {"a": 1}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        MetricsLogger(tmp_path, use_wandb=True)


def test_logger_config_from_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("ROUTEFORMER_LOG_LEVEL", "info")
    monkeypatch.setenv("ROUTEFORMER_LOG_FILE", str(tmp_path / "run.log"))
    logger = set_logger_config()
    try:
        assert logger.level == logging.INFO and len(logger.handlers) == 2
        get_logger("child").info("hello")
        for h in logger.handlers:
            h.flush()
        assert "routeformer_torch.child | hello" in (tmp_path / "run.log").read_text()
    finally:
        monkeypatch.delenv("ROUTEFORMER_LOG_FILE")
        set_logger_config("WARNING")


def test_timers_and_trace(tmp_path):
    profiling.reset_timing()

    @profiling.time_it(name="f")
    def f(x):
        return x + 1

    assert f(1) == 2 and f(2) == 3
    with profiling.TimeIt("block") as t:
        sum(range(1000))
    assert t.elapsed > 0.0
    summary = profiling.timing_summary()
    assert summary["f"]["count"] == 2 and summary["block"]["count"] == 1
    with profiling.device_trace(str(tmp_path / "trace")):
        with profiling.annotate("region"):
            torch.ones(4).sum()
    assert any((tmp_path / "trace").iterdir())
    profiling.reset_timing()
    assert profiling.timing_summary() == {}
