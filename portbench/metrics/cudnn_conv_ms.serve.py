"""cudnn_conv_ms.serve: device ms per window in cuDNN convolution kernels and their layout transposes."""

from portbench.metrics_common import is_conv


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["trace"].kernels:
        return None
    return ctx["trace"].kernel_s(is_conv) / ctx["traced_windows"] * 1e3
