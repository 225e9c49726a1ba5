"""Device time of the GPS backbone (the Informer) in a served request, in ms
a request: the device total of the ``rf.gps_backbone`` span over the
request count.
Read from the program's spans (``spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_unit_ms(ctx, "requests", "rf.gps_backbone", "device_total")
