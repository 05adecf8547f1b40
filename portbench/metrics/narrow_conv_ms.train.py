"""narrow_conv_ms.train: device ms per micro-step in the port's narrow-output convolution kernels (``conv_unit_narrow*``: the forwards of the final block, the mask heads and the gates, which cuDNN ran with layout transposes). A port without them reads nothing."""

KERNEL = "conv_unit_narrow"


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    trace = ctx["trace"]
    if not any(KERNEL in name for _, _, name, _ in trace.kernels):
        return None
    return trace.kernel_s(lambda name: KERNEL in name) / ctx["traced_steps"] * 1e3
