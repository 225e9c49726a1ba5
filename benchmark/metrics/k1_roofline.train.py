"""K1, the fused SwinV2 block, against its roofline, in percent: the least
time its blocks' work needs (``roofline.kernels.k1_call`` for every block
of every backbone pass of the traced steps, each pass's frames) over the
device time of its kernels (its GEMMs and row kernels and the window
attention it launches, K2). Read only where the port's K1 counter counted
every block of every pass."""

from benchmark.roofline import kernels, peaks


def read(ctx):
    v = ctx.config["video_backbone"]
    if ctx.units != "steps" or v["kind"] != "swinv2" or v["gelu"] != "tanh":
        return None
    seconds = ctx.trace.seconds_of({"K1", "K2"})
    passes = ctx.pass_frames()
    blocks = sum(v["depths"])
    if seconds <= 0 or ctx.counters.get("K1") != blocks * len(passes) * ctx.traced_units:
        return None
    bound = sum(depth * peaks.bound_s(*kernels.k1_call(frames, t, c, n, h, kinds))
                for frames in passes
                for t, c, n, h, kinds, depth in kernels.swin_stages(v))
    return 100.0 * bound * ctx.traced_units / seconds
