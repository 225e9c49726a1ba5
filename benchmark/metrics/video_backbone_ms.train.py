"""Device time of the frozen video backbone in a training step, in ms a
step: the device total of the ``rf.video_backbone`` spans (the input and
the target pass, frame conditioning included) over the step count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "steps", "rf.video_backbone", "device_total")
