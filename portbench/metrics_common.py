"""Kernel-name patterns the per-layer readers share."""

# cuDNN's convolution kernels (forward, dgrad, wgrad) and the layout
# transposes it runs around them; the port's own kernels are not convolutions
CONV_PATTERNS = ("fprop", "dgrad", "wgrad", "conv", "cudnn", "nhwcToNchw", "nchwToNhwc")
PORT_KERNELS = ("lta_", "conv_unit", "stack_")


def is_conv(name: str) -> bool:
    return any(p in name for p in CONV_PATTERNS) and not any(p in name for p in PORT_KERNELS)
