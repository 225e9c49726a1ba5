"""Device time of the Perceive stacks in a training step, in ms a step: the
device totals of the ``rf.perceive.*`` spans (frame, gaze and video
encoders, gaze-video decoder; input and target passes) over the step
count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "steps", "rf.perceive.", "device_total")
