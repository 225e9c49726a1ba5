"""The program's spans, read for the per-layer metrics of its layers
(``metrics/*_ms.*.py``); the one place that reads
``routeformer_torch.utils.profiling.timing_summary()``.

The port opens a span at each layer boundary (``rf.train_step``,
``rf.serve.request``, ``rf.place``, ``rf.video_backbone``,
``rf.perceive.*``, ``rf.gps_backbone``, ``rf.loss``, ``rf.backward``,
``rf.optimizer``) whenever the torch profiler records. In a traced run
that is the profiler's settle unit and the traced units, and nothing
else: set-up, the untraced half of the window and the checks after it run
with the profiler off. Each span's table row holds its host total and,
on the card, its device total: the time from the stream reaching its
entry event to reaching its exit event, kernels and the device's waits
for the host inside the span alike.

A reading is per unit: a total over the count of the unit's root span
(``rf.train_step`` a step, ``rf.serve.request`` a request). It is None
where the run is the other kind, where the root's count is not
``traced_units + 1`` (spans were on outside the traced stretch, as with
``ROUTEFORMER_TRACE=1``, or the program has no such span), or where a
device total is missing (no card, or a span that began before CUDA was
in use)."""

from typing import Optional

ROOTS = {"steps": "rf.train_step", "requests": "rf.serve.request"}


def table(ctx) -> dict:
    """The program's span table, read once a run (and kept in
    ``ctx.cache``); empty where the program has none."""
    if "spans" not in ctx.cache:
        try:
            from routeformer_torch.utils import profiling

            ctx.cache["spans"] = profiling.timing_summary()
        except (ImportError, AttributeError):
            ctx.cache["spans"] = {}
    return ctx.cache["spans"]


def _matches(name: str, key: str) -> bool:
    """``key`` names one span, or with a trailing dot every span under it."""
    return name.startswith(key) if key.endswith(".") else name == key


def per_unit_ms(ctx, units: str, key: str, field: str) -> Optional[float]:
    """The spans matching ``key``: their ``field`` (``total`` for the host,
    ``device_total`` for the device) summed, in ms per unit of ``units``."""
    if ctx.units != units:
        return None
    rows = table(ctx)
    root = rows.get(ROOTS[units])
    if root is None or root["count"] != ctx.traced_units + 1:
        return None
    found = [row for name, row in rows.items() if _matches(name, key)]
    if not found or any(field not in row for row in found):
        return None
    return 1e3 * sum(row[field] for row in found) / root["count"]
