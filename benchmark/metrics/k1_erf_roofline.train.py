"""K1 with its exact (erf) gelu epilogue against its roofline, in percent,
read as ``k1_roofline.train`` reads K1 in the tanh configuration: the least
time its blocks' work needs (``roofline.kernels.k1_call`` for every block of
every backbone pass of the traced steps) over the device time of its
kernels and the window attention it launches (K2). The erf is one more
elementwise operation on the fc1 tile, so the work is counted as for the
tanh gelu. Read only in a configuration whose blocks all use the exact gelu,
where the port's K1 counter counted every block of every pass: the blocks
then all took K1's erf epilogue, none the unfused block."""

import dataclasses

from benchmark.readings import reader


def read(ctx):
    v = ctx.config["video_backbone"]
    if v["gelu"] != "exact":
        return None
    as_tanh = dict(ctx.config, video_backbone=dict(v, gelu="tanh"))
    return reader("k1_roofline.train")(dataclasses.replace(ctx, config=as_tanh))
