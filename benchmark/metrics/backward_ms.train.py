"""Device time of a training step's backward, in ms a step: the device
total of the ``rf.backward`` span over the step count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "steps", "rf.backward", "device_total")
