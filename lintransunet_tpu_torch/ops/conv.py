"""3D convolution, InstanceNorm and LeakyReLU on ``(N, C, H, W, D)``.

Port of ``lintransunet_tpu/ops/conv.py``. The convolution is PyTorch's own
(cuDNN on the card), but for the depthwise convolutions that cuDNN computes
with its generic engine, their forward (``ops.conv_depthwise``) and their
weight gradient (``ops.conv_wgrad``), and the forward of the bf16
convolutions with at most 8 outputs (``ops.conv_narrow``). InstanceNorm matches ``nn.InstanceNorm3d`` defaults
(affine-free, eps 1e-5, biased variance) but computes its statistics in
f32 in the JAX package's single pass, E[x^2] - E[x]^2 (``moment_stats``),
not torch's two-pass form.
"""

from typing import Optional

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.ops import conv_depthwise, conv_narrow, conv_wgrad


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride=1, padding=0,
           groups: int = 1) -> torch.Tensor:
    """Conv with symmetric explicit padding, computed in ``x``'s dtype
    (parameters are cast to it, as flax ``dtype`` does). The convolutions
    that ``conv_depthwise.routes`` picks take the forward of
    ``csrc/conv_depthwise.cu``, under grad through
    ``conv_wgrad.DepthwiseConv3d``; those that ``conv_wgrad.routes`` picks
    take ``conv_wgrad.DepthwiseConv3d``, cuDNN's forward with the weight
    gradient of ``csrc/conv_wgrad.cu``; those that ``conv_narrow.routes``
    picks take the forward of ``csrc/conv_narrow.cu`` with cuDNN's
    gradients."""
    if bias is not None:
        bias = bias.to(x.dtype)
    if conv_depthwise.routes(x, weight, stride, padding, groups):
        if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                        or (bias is not None and bias.requires_grad)):
            return conv_wgrad.DepthwiseConv3d.apply(x, weight, bias)
        return conv_depthwise.conv_depthwise(x, weight, bias)
    if conv_wgrad.routes(x, weight, stride, padding, groups):
        return conv_wgrad.DepthwiseConv3d.apply(x, weight, bias)
    if conv_narrow.routes(x, weight, stride, padding, groups):
        return conv_narrow.conv3d(x, weight, bias)
    return F.conv3d(x, weight.to(x.dtype), bias, stride, padding, 1, groups)


def moment_stats(x32: torch.Tensor, dims, eps: float):
    """Single-pass (mean, rsqrt(var + eps)) over ``dims``."""
    mean = x32.mean(dim=dims, keepdim=True)
    meansq = x32.square().mean(dim=dims, keepdim=True)
    var = (meansq - mean.square()).clamp_min(0.0)
    return mean, torch.rsqrt(var + eps)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(N, C) normalisation over the spatial dims, affine-free; the
    statistics and the normalise run in f32, the result has ``x``'s dtype."""
    x32 = x.float()
    mean, rstd = moment_stats(x32, tuple(range(2, x.dim())), eps)
    return ((x32 - mean) * rstd).to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """torch ``nn.LeakyReLU`` default slope."""
    return F.leaky_relu(x, negative_slope)
