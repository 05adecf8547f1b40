"""cudnn_conv_ms.train: device ms per micro-step in cuDNN convolution kernels (forward, data and weight gradients) and their layout transposes."""

from portbench.metrics_common import is_conv


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["trace"].kernels:
        return None
    return ctx["trace"].kernel_s(is_conv) / ctx["traced_steps"] * 1e3
