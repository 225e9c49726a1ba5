"""Device time of placing a request's tensors on the card, in ms a request:
the device total of the ``rf.place`` span (the copies from pinned host
memory) over the request count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "requests", "rf.place", "device_total")
