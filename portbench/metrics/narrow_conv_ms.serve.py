"""narrow_conv_ms.serve: device ms per window in the port's narrow-output convolution kernels (``conv_unit_narrow*``: the final block, the mask heads and the gates, which cuDNN ran with layout transposes). A port without them reads nothing."""

KERNEL = "conv_unit_narrow"


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    trace = ctx["trace"]
    if not any(KERNEL in name for _, _, name, _ in trace.kernels):
        return None
    return trace.kernel_s(lambda name: KERNEL in name) / ctx["traced_windows"] * 1e3
