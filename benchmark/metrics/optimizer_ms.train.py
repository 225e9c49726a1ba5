"""Device time of a training step's update, in ms a step: the device total
of the ``rf.optimizer`` span (the gradients' norms, the clip and the
grouped AdamW) over the step count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "steps", "rf.optimizer", "device_total")
