"""Host time of a training step's call into the program, in ms a step: the
host total of the ``rf.train_step`` span (zeroing the gradients, forward,
loss, backward, clip and AdamW, as the host dispatches them) over its
count. Set beside the device totals of the step's layers, it says which
layer the host paces.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "steps", "rf.train_step", "total")
