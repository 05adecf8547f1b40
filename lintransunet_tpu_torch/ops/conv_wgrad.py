"""The weight gradient of the depthwise 3x3x3 convolutions that cuDNN sends
to its generic engine: the CUDA kernel, its plain version, the routing and
the autograd Function.

On the H100, cuDNN computes the bf16 weight gradient of a depthwise
3x3x3 stride-1 convolution over 256 channels (the flagship's and the
bottleneck's positional encodings, ``blocks.ConvPosEmbed3d``) with
``cudnn::cnn::convolveNd_wgrad_engine``, 42-102 ms a call at the
training step's shapes; at 128 channels it takes an implicit-GEMM kernel
(PERF.md, section 6). ``routes`` picks exactly those convolutions by what
a call shows: bf16, depthwise, kernel 3, stride 1, padding 1, more than
``ENGINE_CHANNELS`` channels, and a weight that wants a gradient while
grad mode is on. ``ops.conv3d`` sends them through ``DepthwiseConv3d``,
and the depthwise convolutions that ``conv_depthwise.routes`` picks under
grad too (channels-last CUDA inputs, 128 channels among them): its forward
is ``conv_depthwise``'s kernel where ``conv_depthwise.routes`` takes the
input and cuDNN's ``F.conv3d`` elsewhere, its data and bias gradients are
cuDNN's calls as before, and its weight gradient is
``depthwise_weight_grad`` above ``ENGINE_CHANNELS`` and cuDNN's, as
autograd computes it for ``F.conv3d``, at or below.

``depthwise_weight_grad`` dispatches on the device of its inputs: CPU
tensors go to ``depthwise_weight_grad_reference`` (the plain f32 weight
gradient); CUDA tensors launch ``csrc/conv_wgrad.cu`` or raise. Both return
the f32 gradient, summed in f32 from the bf16 operands, where cuDNN
returned it in bf16. ``depthwise_weight_grad.launches`` counts the
kernel's calls (two CUDA launches each: the chunks' partial sums, then
their sum in a fixed order, so the gradient is the same bits on every
run). The kernel replaces no TPU kernel: the JAX package left its
convolutions to XLA.
"""

import array
import functools

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.ops import conv_depthwise

ENGINE_CHANNELS = 128  # depthwise widths above this reach cuDNN's generic engine
MIN_CHUNK = 64         # voxels a chunk of the kernel's split, at least
BLOCKS_PER_SM = 4      # the split aims at this many blocks an SM

_library = None


def _lib():
    global _library
    if _library is None:
        from lintransunet_tpu_torch import kernels

        _library = kernels.load("conv_wgrad")
    return _library


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


def routes(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0, groups: int = 1) -> bool:
    """True where ``ops.conv3d(x, weight, ..., stride, padding, groups)``
    takes ``DepthwiseConv3d``: a bf16 depthwise 3x3x3 convolution with
    stride 1 and padding 1 over more than ``ENGINE_CHANNELS`` channels,
    whose weight wants a gradient while grad mode is on."""
    return (torch.is_grad_enabled() and weight.requires_grad and x.dtype == torch.bfloat16
            and x.dim() == 5 and tuple(weight.shape[1:]) == (1, 3, 3, 3)
            and groups == x.shape[1] == weight.shape[0] > ENGINE_CHANNELS
            and _triple(stride) == (1, 1, 1) and _triple(padding) == (1, 1, 1))


def depthwise_weight_grad_reference(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The plain f32 weight gradient, (C, 1, 3, 3, 3), of the depthwise
    3x3x3 convolution with stride 1 and padding 1 of ``x`` whose output
    gradient is ``grad``; both (N, C, S1, S2, S3)."""
    c = x.shape[1]
    return torch.nn.grad.conv3d_weight(x.float(), (c, 1, 3, 3, 3), grad.float(),
                                       stride=1, padding=1, groups=c)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunks(channels: int, voxels: int, sms: int) -> int:
    """The kernel's split of the voxels: enough chunks for ``BLOCKS_PER_SM``
    blocks an SM over the channel blocks of 32, none under ``MIN_CHUNK``
    voxels."""
    channel_blocks = -(-channels // 32)
    return max(1, min(-(-BLOCKS_PER_SM * sms // channel_blocks), -(-voxels // MIN_CHUNK)))


def depthwise_weight_grad(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The f32 weight gradient, (C, 1, 3, 3, 3), of the depthwise 3x3x3
    stride-1 padding-1 convolution of ``x`` whose output gradient is
    ``grad``; both (N, C, S1, S2, S3), bf16 on the card, any strides."""
    if x.shape != grad.shape or x.dim() != 5:
        raise ValueError(f"x {tuple(x.shape)} and its output gradient {tuple(grad.shape)} "
                         "must be one (N, C, S1, S2, S3) shape")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no depthwise weight-gradient path for {x.device}")
        return depthwise_weight_grad_reference(x, grad)
    if x.dtype != torch.bfloat16 or grad.dtype != torch.bfloat16 or grad.device != x.device:
        raise ValueError("the CUDA kernel takes bf16 x and gradient on one device")
    n, c, s1, s2, s3 = x.shape
    split = chunks(c, n * s1 * s2 * s3, _sm_count(x.device.index))
    partial = torch.empty((split, c, 27), dtype=torch.float32, device=x.device)
    dw = torch.empty((c, 1, 3, 3, 3), dtype=torch.float32, device=x.device)
    dims = array.array("q", list(x.shape) + list(x.stride()) + list(grad.stride()))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().cw_depthwise(x.data_ptr(), grad.data_ptr(), partial.data_ptr(),
                                  dw.data_ptr(), dims.buffer_info()[0], split, stream)
    if err != 0:
        raise RuntimeError(f"depthwise weight-gradient kernel launch failed: CUDA error {err}")
    depthwise_weight_grad.launches += 1
    return dw


depthwise_weight_grad.launches = 0


class DepthwiseConv3d(torch.autograd.Function):
    """``F.conv3d(x, weight.to(x.dtype), bias, 1, 1, 1, C)`` for a routed
    depthwise convolution (``routes``, or ``conv_depthwise.routes`` under
    grad). The forward is ``conv_depthwise``'s kernel where
    ``conv_depthwise.routes`` takes x, else cuDNN's; the data and bias
    gradients are cuDNN's ``convolution_backward``; the gradient of the
    (f32) weight is ``depthwise_weight_grad`` above ``ENGINE_CHANNELS``,
    else cuDNN's from the same call, as autograd computes it for
    ``F.conv3d``. ``bias`` is already in x's dtype."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.weight_dtype = weight.dtype
        ctx.with_bias = bias is not None
        c = x.shape[1]
        if conv_depthwise.routes(x, w, 1, 1, c):
            return conv_depthwise.conv_depthwise(x, w, bias)
        return F.conv3d(x, w, bias, 1, 1, 1, c)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        kernel_w = need_w and x.shape[1] > ENGINE_CHANNELS
        gx, gw, gb = None, None, None
        mask = [need_x, need_w and not kernel_w, need_b]
        if any(mask):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                grad, x, w, [w.shape[0]] if ctx.with_bias else None, [1, 1, 1], [1, 1, 1],
                [1, 1, 1], False, [0, 0, 0], x.shape[1], mask)
        if kernel_w:
            gw = depthwise_weight_grad(x, grad)
        return gx, None if gw is None else gw.to(ctx.weight_dtype), gb
