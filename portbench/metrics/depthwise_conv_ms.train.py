"""depthwise_conv_ms.train: device ms per micro-step in the port's depthwise-convolution kernel (``conv_unit_depthwise*``: the positional encodings' forwards, which cuDNN ran on its per-channel generic engine). A port without it reads nothing."""

KERNEL = "conv_unit_depthwise"


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    trace = ctx["trace"]
    if not any(KERNEL in name for _, _, name, _ in trace.kernels):
        return None
    return trace.kernel_s(lambda name: KERNEL in name) / ctx["traced_steps"] * 1e3
