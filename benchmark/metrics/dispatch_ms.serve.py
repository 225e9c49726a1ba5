"""Host time of a served request's call into the program, in ms a request:
the host total of the ``rf.serve.request`` span (placement and the eval
forward as the host dispatches them, up to the call's return) over its
count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "requests", "rf.serve.request", "total")
