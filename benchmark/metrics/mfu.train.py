"""The training step's share of the card's bf16 peak, in percent: the
operations the plain reference needs for one step at the cell's shapes
(``roofline.flops``: forward of both passes and backward, nothing
recomputed) over the wall time a step took in the untraced part of the
window times 989 TFLOP/s."""

from benchmark.roofline import flops, peaks


def read(ctx):
    if ctx.units != "steps" or not ctx.unit_s:
        return None
    work = flops.train_step_flops(ctx.config, ctx.shapes["input"], ctx.shapes["target"],
                                  ctx.mix["epoch"])
    return 100.0 * work / (ctx.unit_s * peaks.PEAK_BF16_FLOPS)
