"""One run of one benchmark cell on the card it is started on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``: the configuration's file, the mix's
``traffic/<mix>.json`` (whose ``kind`` picks the loop in ``loops.py``), the
limits of ``limits/<cell>.json`` and, with ``--trace 1``, the readers
``metrics/<metric>.py`` of the per-layer metrics that list the cell. The
last line of standard output is the result; the host's state, the peak
memory and the compared numbers come on earlier lines, and the compared
numbers with their limits are the last lines of standard error too.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "routeformer_tpu")


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _cell_metrics(entries: list, cell: str, reported: set) -> list:
    """The metrics of ``entries`` that this cell reports: those listing it,
    or, without a list, those whose end-to-end metric it reports."""
    return [m for m in entries if cell in m.get("workloads", [])
            or ("workloads" not in m and m.get("moves", m["name"]) in reported)]


def _shapes(mix: dict, config: dict) -> dict:
    import torch

    g, b = config["gps_backbone"], mix["batch"]
    shapes = {}
    for part, length in (("input", g["seq_len"]), ("target", g["pred_len"])):
        shapes[part] = {"gps": ((b, length, 2), torch.float32),
                        "gaze": ((b, mix["gaze_len"], 2), torch.float32)}
        for view, (h, w) in mix["frame_hw"].items():
            shapes[part][view] = ((b, length, h, w, 3), torch.uint8)
    return shapes


def report_lines(outcome) -> list:
    """The lines before the result: the host's state beside the window, the
    peak memory, the run's notes and every compared reading."""
    lines = [f"host at {when}: " + json.dumps(state) for when, state in outcome.host]
    lines.append(f"peak device memory (max_memory_allocated): {outcome.peak_bytes} bytes")
    lines.append("notes: " + json.dumps(outcome.notes, default=str))
    if outcome.counters is not None:
        lines.append(f"traced: launch counters {outcome.counters}; "
                     f"untraced {outcome.unit_s} s a unit")
    lines.append("all readings: " + json.dumps(outcome.numbers))
    return lines


def result_line(bench, cell, config, mix, outcome, bounds, trace: bool, device_name: str) -> dict:
    """The run's result: the contract's keys, with ``check`` last."""
    from benchmark import check
    from benchmark.readings import Context, read

    reported = {"setup_s", *outcome.metrics}
    e2e = _cell_metrics(bench["end_to_end"], cell["name"], reported)
    metrics, extra = {}, {}
    if trace:
        ctx = Context(config, mix, outcome.units, mix["trace_units"], outcome.trace,
                      outcome.counters, outcome.unit_s, _shapes(mix, config))
        for m in _cell_metrics(bench["per_layer"], cell["name"], {m["name"] for m in e2e}):
            value = read(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        summary = outcome.trace
        extra["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in summary.seconds_by_label().items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[name, s] for name, s in summary.gaps[:10]],
        }
    else:
        values = dict(outcome.metrics, setup_s=outcome.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    device = {"platform": "gpu", "kind": device_name, "count": cell["chips"],
              "memory_peak_bytes": int(outcome.peak_bytes)}
    if trace:
        device.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
    return {"correct": check.judge(outcome.numbers, bounds), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device, **extra,
            "check": check.describe(outcome.numbers, bounds)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # One process with few threads: the host side is one dispatch thread.
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    cache = ROOT / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))

    bench = spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    from benchmark import check, hoststate, loops
    from benchmark.traffic import generator

    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    mix = generator.load(cell["traffic"])
    bounds = check.limits(cell["name"])
    print("host before set-up: " + json.dumps(hoststate.sample("cuda")), flush=True)

    outcome = loops.KINDS[mix["kind"]](config, mix, args.seed, args.seconds, bool(args.trace),
                                      "cuda", T0)
    for line in report_lines(outcome):
        print(line)
    found = forbidden_modules()
    if found:
        print(f"modules that a run must not load were loaded: {found}", file=sys.stderr)
        return 4
    result = result_line(bench, cell, config, mix, outcome, bounds, bool(args.trace),
                         torch.cuda.get_device_name(0))
    for name, c in result["check"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
