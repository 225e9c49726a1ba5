"""K4, dense flash attention in the ViT's blocks, against its roofline, in
percent: the least time its calls' work needs (``roofline.kernels.k4_call``
over each block's frames, tokens, heads and head width) over the device
time of its kernels. Read only where the port's K4 counter counted one
call a block a request."""

from benchmark.roofline import kernels, peaks


def read(ctx):
    v = ctx.config["video_backbone"]
    if ctx.units != "requests" or v["kind"] != "vit":
        return None
    seconds = ctx.trace.seconds_of({"K4"})
    if seconds <= 0 or ctx.counters.get("K4") != v["depth"] * ctx.traced_units:
        return None
    tokens = (v["img_size"] // v["patch_size"]) ** 2
    frames = sum(ctx.pass_frames())
    call = peaks.bound_s(*kernels.k4_call(frames, tokens, v["heads"], v["width"] // v["heads"]))
    return 100.0 * v["depth"] * call * ctx.traced_units / seconds
