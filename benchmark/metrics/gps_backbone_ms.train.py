"""Device time of the GPS backbone (the Informer) in a training step, in ms
a step: the device total of the ``rf.gps_backbone`` spans over the step
count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "steps", "rf.gps_backbone", "device_total")
