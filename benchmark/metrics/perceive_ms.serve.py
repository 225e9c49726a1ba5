"""Device time of the Perceive stacks in a served request, in ms a request:
the device totals of the ``rf.perceive.*`` spans over the request count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "requests", "rf.perceive.", "device_total")
