"""K3b, the fused Perceive layer backward, against its roofline, in
percent: the least time its layers' work needs (``roofline.kernels.k3b_layer``
for the frame, video and gaze encoders' layers that received a gradient)
over the device time of the kernels launched inside the fused stack's
backward. The port's K3b counter says how many layers ran: the frame and
video encoders' every step, the gaze encoder's where gaze dropout left it
in the graph."""

from benchmark.roofline import kernels, peaks


def read(ctx):
    if ctx.units != "steps":
        return None
    seconds = ctx.trace.seconds_launched_in("FusedStackBackward")
    cfg, g, v = ctx.config["model"], ctx.config["gps_backbone"], ctx.config["video_backbone"]
    n, b = cfg["encoder_layers"], ctx.mix["batch"]
    launched = ctx.counters.get("K3b", 0)
    gaze_steps, rest = divmod(launched - 2 * n * ctx.traced_units, n)
    if not seconds or rest or not 0 <= gaze_steps <= ctx.traced_units:
        return None
    grid = v["img_size"] // v["patch_size"] // 2 ** (len(v["depths"]) - 1)
    layer = {
        "frame": kernels.k3b_layer(ctx.pass_frames()[0], grid * grid + 1, f=cfg["encoder_d_ff"]),
        "video": kernels.k3b_layer(b, 4 * g["seq_len"], f=cfg["encoder_d_ff"]),
        "gaze": kernels.k3b_layer(b, g["seq_len"], f=cfg["encoder_d_ff"]),
    }
    bound = {k: n * peaks.bound_s(*w) for k, w in layer.items()}
    total = ctx.traced_units * (bound["frame"] + bound["video"]) + gaze_steps * bound["gaze"]
    return 100.0 * total / seconds
