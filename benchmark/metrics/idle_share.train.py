"""Share of the traced stretch of training steps in which no operation
ran on the device: 1 - (the union of device-operation intervals / the
stretch's wall time), in percent."""


def read(ctx):
    if ctx.units != "steps" or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
