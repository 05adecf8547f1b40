"""wgrad_unit_ms.train: device ms per micro-step in the port's depthwise weight-gradient kernels (``conv_unit_wgrad*``, which replace cuDNN's generic wgrad engine). A port without them reads nothing."""

KERNEL = "conv_unit_wgrad"


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    trace = ctx["trace"]
    if not any(KERNEL in name for _, _, name, _ in trace.kernels):
        return None
    return trace.kernel_s(lambda name: KERNEL in name) / ctx["traced_steps"] * 1e3
