"""BENCHMARK.json and the result line against the benchmark's contract; a
run without a card, or without the program beside it, fails."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check, loops
from benchmark.run import ROOT, result_line, spec
from benchmark.tests import tiny
from benchmark.traffic import generator

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}


def test_benchmark_json_keeps_to_the_contract():
    bench = spec()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert generator.load(w["traffic"])["kind"] in loops.KINDS
        assert set(check.limits(w["name"]))  # every cell has its limits
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def _tiny_outcome(kind):
    cfg = tiny.config(kind)
    if kind == "swinv2":
        return cfg, tiny.mix("train_b16"), loops.train_step(
            cfg, tiny.mix("train_b16"), 3, 0.2, False, "cpu", time.perf_counter(),
            build=tiny.build_train_f32)
    return cfg, tiny.mix("serve_b1"), loops.closed_loop(
        cfg, tiny.mix("serve_b1"), 3, 0.5, False, "cpu", time.perf_counter(),
        build=tiny.build_serve_f32)


@pytest.mark.parametrize("kind,cell", [("swinv2", "swinv2_train_b16"),
                                       ("vit", "dinov2_serve_b1")])
def test_the_result_line_carries_the_contract_keys(monkeypatch, kind, cell):
    monkeypatch.setenv("ROUTEFORMER_FUSION_KERNEL", "1")
    bench = spec()
    cfg, mix, outcome = _tiny_outcome(kind)
    bounds = check.limits(cell)
    cells = {w["name"]: w for w in bench["workloads"]}
    result = result_line(bench, cells[cell], cfg, mix, outcome, bounds, False, "cpu")
    assert set(result) == RESULT_KEYS and list(result)[-1] == "check"
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    wanted = {m["name"] for m in bench["end_to_end"]
              if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == wanted
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert set(result["check"]) == set(bounds)
    assert result["correct"] is True  # the float32 program agrees with the reference
    json.dumps(result)


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "dinov2_serve_b1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_a_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    done = _run(ROOT)
    assert done.returncode != 0 and '"correct"' not in done.stdout


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    done = _run(tmp_path, env)
    assert done.returncode != 0 and '"correct"' not in done.stdout
