"""A served request's share of the card's bf16 peak, in percent: the
operations of the plain reference's eval forward at the request's shapes
(``roofline.flops``) over the wall time a request took in the untraced
part of the window times 989 TFLOP/s."""

from benchmark.roofline import flops, peaks


def read(ctx):
    if ctx.units != "requests" or not ctx.unit_s:
        return None
    work = flops.request_flops(ctx.config, ctx.shapes["input"])
    return 100.0 * work / (ctx.unit_s * peaks.PEAK_BF16_FLOPS)
