"""What decides ``correct``: the numbers that compare the program's timed
path with the plain reference. A cell's limits (``limits/<cell>.json``)
name the numbers it holds; the others are readings, printed by every run.
``PERF.md`` gives the readings each limit was set from, and why the
widest gaps are readings only: the model's hard ProbSparse selection
moves single rows by O(1) under rounding, so a widest gap reads as high
for the program as for the control.

Training (the first three steps of the object the window drives):

- ``frame_gap``: the frame encoder's output in step 1 (the frozen
  backbone's features through the Perceive stack, in training mode);
- ``grad_gap_median``: the first gradient as the optimizer got it (Adam's
  first moment after one step over 1 - beta1): per trained leaf, the gap
  between the two norms over the reference's norm of that leaf or of the
  median leaf, whichever is larger; the median over the leaves
  (``grad_gap``: the widest);
- ``change_gap_median``: the change of the trained parameters over the
  three steps in the same way, over the leaves whose reference gradient is
  at least a thousandth of the median leaf's (``moving_leaves``)
  (``change_gap``: the widest);
- ``loss_glue_gap``: the first step's loss against the reference's loss
  function on that step's own outputs over every row (the forward's
  future GPS and visual features, the target pass's features): a loss
  taken over other rows than the batch's, or another mean, shows here;
- ``frozen_moved``: the largest change of a frozen backbone parameter,
  which the reference leaves where it was (limit 0);
- ``loss_gap``, ``loss1_gap``: the widest relative gap of the three
  steps' losses, and the first step's; ``grad_norm_gap``: the first
  step's global gradient norm before clipping.

Serving: ``serve_numbers``.
"""

import json
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parent / "limits"


def limits(workload: str) -> dict:
    return json.loads((LIMITS / f"{workload}.json").read_text())


def leaf_gaps(got: dict, want: dict, names) -> list:
    """|got - want| / max(want, median of want) for each of ``names``."""
    names = list(names)
    if not names:
        return [0.0]
    median = float(torch.tensor([want[n] for n in names]).median())
    return [abs(got[n] - want[n]) / max(want[n], median, 1e-30) for n in names]


def rel_gap(got, want) -> float:
    """max |got - want| / max |want|; infinite where the shapes differ."""
    if got is None or got.shape != want.shape:
        return float("inf")
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def moving_leaves(ref: dict) -> list:
    """The trained leaves whose reference gradient is at least a thousandth
    of the median leaf's. The others have a gradient of nought but for
    rounding (a bias ahead of a batch norm on batch statistics, whose
    per-channel constant the norm takes away), which Adam turns into full
    steps on either side."""
    trained = [n for n in ref["grad_norms"] if "video_backbone" not in n]
    median = float(torch.tensor([ref["grad_norms"][n] for n in trained]).median())
    return [n for n in trained if ref["grad_norms"][n] >= 1e-3 * median]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``losses`` (three floats), ``grad_norm`` (the
    first step's global norm before clipping), ``grad_norms`` and
    ``change_norms`` ({leaf: float}), ``loss_of_outputs`` (the reference's
    loss of the first step's outputs over every row); ``prog`` also
    ``frozen_moved``."""
    trained = [n for n in ref["grad_norms"] if "video_backbone" not in n]
    moving = moving_leaves(ref)
    grad = leaf_gaps(prog["grad_norms"], ref["grad_norms"], trained)
    change = leaf_gaps(prog["change_norms"], ref["change_norms"], moving)
    losses = list(zip(prog["losses"], ref["losses"]))
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in losses),
        "loss1_gap": abs(losses[0][0] - losses[0][1]) / abs(losses[0][1]),
        "loss_glue_gap": abs(prog["losses"][0] - prog["loss_of_outputs"])
        / abs(prog["loss_of_outputs"]),
        "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"],
        "grad_gap": max(grad),
        "change_gap": max(change),
        "grad_gap_median": float(torch.tensor(grad).median()),
        "change_gap_median": float(torch.tensor(change).median()),
        "frozen_moved": prog["frozen_moved"],
        "frame_gap": rel_gap(prog.get("frame"), ref["frame"]),
    }


def worst_leaves(prog: dict, ref: dict, key: str, k: int = 5) -> list:
    """The ``k`` leaves that set the widest gap of ``key`` norms, over the
    leaves that ``train_numbers`` compares there (every trained leaf for
    the gradient, the moving ones for the change): [(leaf, program,
    reference)]."""
    if key == "change_norms":
        names = moving_leaves(ref)
    else:
        names = [n for n in ref[key] if "video_backbone" not in n]
    median = float(torch.tensor([ref[key][n] for n in names]).median())
    names.sort(key=lambda n: -abs(prog[key][n] - ref[key][n]) / max(ref[key][n], median, 1e-30))
    return [(n, prog[key][n], ref[key][n]) for n in names[:k]]


def left_out(ref: dict) -> dict:
    """The trained leaves that the change leaves out: how many have a
    reference gradient of exactly nought (a stream the step dropped), and
    the others by name with their gradient's norm over the median leaf's."""
    trained = [n for n in ref["grad_norms"] if "video_backbone" not in n]
    median = float(torch.tensor([ref["grad_norms"][n] for n in trained]).median())
    moving = set(moving_leaves(ref))
    out = [(n, ref["grad_norms"][n] / median) for n in trained if n not in moving]
    return {"nought": sum(1 for _, r in out if r == 0.0),
            "rounding": [(n, r) for n, r in out if r > 0.0]}


def _per_request(got, want) -> list:
    return [rel_gap(g, w) for g, w in zip(got, want)]


def _quantile(got, want, q) -> float:
    gaps = torch.cat([((g.float() - w.float()).abs()
                       / w.float().abs().max().clamp(min=1e-30)).flatten()
                      for g, w in zip(got, want)])
    return float(torch.quantile(gaps, q))


def serve_numbers(answers: list, prog: list, ref: list, stages: list, glue: list) -> dict:
    """Per sampled request: ``answers`` are the (displacement, dense) the
    window returned; ``prog`` the records of the program's replay of the
    request after the window (``loops._record``), ``ref`` the reference's
    record end to end from the request, ``stages`` the reference's stages
    on the replay's stage inputs and ``glue`` the reference's own glue
    between the stages run on the replay's stage outputs
    (``loops.reference_glue``). A gap is max |got - want| / max |want|
    over one request (``rel_gap``):

    - ``frame_gap``: the frame encoder's output, end to end from the
      request (the video backbone and the frame encoder), the widest;
    - ``<stage>_request_median_gap`` for the gaze encoder, the gaze-video
      decoder, the video encoder and the answer (``displacement``,
      ``dense``: the GPS backbone and the integration onto the last fix):
      each from the inputs the program's stage got, the median over the
      requests of each request's widest gap;
    - ``answer_request_median_gap``: the window's answer against the
      reference end to end from the request, the same way;
    - ``glue_gap``: every stage's input and the answer as the reference's
      glue builds them from the program's stage outputs, against the
      program's, the widest;
    - ``replay_gap``: the replay's answer against the window's.

    The widest gaps of the stages (``<stage>_gap``) and their element
    quantiles are readings."""
    def pick(records, name):  # a stage's output, or the answer's part
        return [r[name][1].cpu() if isinstance(r[name], tuple) else r[name] for r in records]

    out = {"frame_gap": max(_per_request(pick(prog, "frame_encoder"),
                                         pick(ref, "frame_encoder")))}
    pairs = {
        "gaze": (pick(prog, "gaze_encoder"), [s["gaze_encoder"].cpu() for s in stages]),
        "decoder": (pick(prog, "gaze_video_decoder"),
                    [s["gaze_video_decoder"].cpu() for s in stages]),
        "video": (pick(prog, "video_encoder"), [s["video_encoder"].cpu() for s in stages]),
        "displacement": (pick(prog, "displacement"), [s["displacement"] for s in stages]),
        "dense": (pick(prog, "dense"), [s["dense"] for s in stages]),
    }
    for name, (got, want) in pairs.items():
        per = _per_request(got, want)
        out[f"{name}_gap"] = max(per)
        out[f"{name}_request_median_gap"] = float(torch.tensor(per).median())
        out[f"{name}_median_gap"] = _quantile(got, want, 0.5)
        out[f"{name}_p90_gap"] = _quantile(got, want, 0.9)
    end = [max(rel_gap(a[0], r["displacement"]), rel_gap(a[1], r["dense"]))
           for a, r in zip(answers, ref)]
    out["answer_request_median_gap"] = float(torch.tensor(end).median())
    out["answer_gap"] = max(end)
    gaps = []
    for p, g in zip(prog, glue):
        for name, want in g.items():
            if name in ("displacement", "dense"):
                gaps.append(rel_gap(p[name], want))
            else:
                gaps += [rel_gap(x.cpu(), y.cpu()) for x, y in zip(p[name][0], want)]
    out["glue_gap"] = max(gaps)
    out["replay_gap"] = max(max(rel_gap(a[0], p["displacement"]), rel_gap(a[1], p["dense"]))
                            for a, p in zip(answers, prog))
    return out


def judge(numbers: dict, bounds: dict) -> bool:
    """Every number within its limit (a limit of 0 asks for equality)."""
    return all(bool(numbers[k] <= bounds[k]) for k in bounds)


def describe(numbers: dict, bounds: dict) -> dict:
    """{name: {"value": number, "limit": limit}} in ``bounds``' order."""
    return {k: {"value": numbers[k], "limit": bounds[k]} for k in bounds}
