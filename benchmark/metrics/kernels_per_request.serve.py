"""Device kernels a served request, counted in the traced stretch."""


def read(ctx):
    if ctx.units != "requests" or not ctx.trace.kernels():
        return None
    return len(ctx.trace.kernels()) / ctx.traced_units
