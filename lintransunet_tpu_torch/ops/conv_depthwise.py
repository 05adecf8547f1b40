"""The forward of bf16 depthwise 3x3x3 convolutions on channels-last inputs:
the CUDA kernel, its plain version and the routing.

On the H100 cuDNN runs the depthwise convolution of the positional
encodings (``blocks.ConvPosEmbed3d``, 128 and 256 channels, on the
channels-last view of the tokens that ``blocks.peg_on_tokens`` makes) with
its generic engine, ``implicit_convolveNd_sgemm``, launched once per channel:
13.1 ms of a training micro-step and 3.1 ms of a served window for a few
microseconds of compulsory traffic (PERF.md, section 6). ``routes`` picks
such convolutions by what a call shows: a CUDA bf16 input of 5 dims laid out
channels last, C a multiple of 8, groups equal to C and to the weight's
outputs, a (1, 3, 3, 3) kernel, stride 1 and padding 1. f32 models, CPU
tensors and channels-first inputs keep ``F.conv3d``. ``ops.conv3d`` sends
the routed calls here: under grad through ``conv_wgrad.DepthwiseConv3d``,
whose forward is this kernel and whose gradients stay cuDNN's and
``conv_wgrad``'s; otherwise (serving) to ``conv_depthwise`` directly.

``conv_depthwise`` dispatches on the device of its input: CPU tensors go to
``conv_depthwise_reference`` (f32 ``F.conv3d`` of the bf16-rounded
operands, rounded once to bf16); CUDA tensors launch
``csrc/conv_depthwise.cu`` (one launch) or raise. Its output has the input's
channels-last layout, as ``F.conv3d``'s has for such an input.
``conv_depthwise.launches`` counts its calls on the card. The kernel
replaces no TPU kernel: the JAX package left its convolutions to XLA.
"""

import array

import torch
import torch.nn.functional as F

VECTOR = 8  # channels a thread of the kernel: one 16-byte vector

_library = None


def _lib():
    global _library
    if _library is None:
        from lintransunet_tpu_torch import kernels

        _library = kernels.load("conv_depthwise")
    return _library


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


def takes(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0, groups: int = 1) -> bool:
    """True where the kernel computes ``F.conv3d(x, weight, _, stride,
    padding, 1, groups)``, whatever the device: bf16 x of 5 dims laid out
    channels last (its memory (N, S1, S2, S3, C) in order) on a 16-byte
    boundary, C a multiple of 8, groups == C == the weight's outputs, a
    (1, 3, 3, 3) kernel, stride 1 and padding 1."""
    if x.dtype != torch.bfloat16 or x.dim() != 5 or weight.dim() != 5:
        return False
    c = x.shape[1]
    return (c % VECTOR == 0 and groups == c == weight.shape[0]
            and tuple(weight.shape[1:]) == (1, 3, 3, 3)
            and _triple(stride) == (1, 1, 1) and _triple(padding) == (1, 1, 1)
            and x.is_contiguous(memory_format=torch.channels_last_3d)
            and x.data_ptr() % 16 == 0)


def routes(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0, groups: int = 1) -> bool:
    """True where ``ops.conv3d(x, weight, ..., stride, padding, groups)``
    takes the kernel: a CUDA input that ``takes`` accepts."""
    return x.is_cuda and takes(x, weight, stride, padding, groups)


def conv_depthwise_reference(x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor = None) -> torch.Tensor:
    """The plain version: f32 ``F.conv3d`` of x, weight and bias rounded to
    bf16, stride 1, padding 1, groups C, the result rounded once to x's
    dtype, laid out channels last."""
    def rounded(t):
        return None if t is None else t.to(torch.bfloat16).float()

    y = F.conv3d(rounded(x), rounded(weight), rounded(bias), 1, 1, 1, x.shape[1])
    return y.to(x.dtype, memory_format=torch.channels_last_3d)


def conv_depthwise(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor = None) -> torch.Tensor:
    """``F.conv3d(x, weight.to(x.dtype), bias, 1, 1, 1, C)`` for x (N, C, S1,
    S2, S3) and weight (C, 1, 3, 3, 3) that ``takes`` accepts; weight f32 or
    bf16 (rounded to bf16 as ``.to`` rounds), bias (C,) in x's dtype or None.
    bf16 products summed in f32, the bias added in f32, the output rounded
    to bf16 once and laid out as x."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no depthwise-convolution path for {x.device}")
        return conv_depthwise_reference(x, weight, bias)
    c = x.shape[1] if x.dim() == 5 else 0
    if not takes(x, weight, 1, 1, c):
        raise ValueError(f"the depthwise-convolution kernel does not take x {tuple(x.shape)} "
                         f"{x.dtype} strides {x.stride()} with weight {tuple(weight.shape)}")
    if weight.dtype not in (torch.float32, torch.bfloat16) or weight.device != x.device:
        raise ValueError("the kernel takes an f32 or bf16 weight on the input's device")
    if bias is not None and (bias.dtype != torch.bfloat16 or bias.shape != (c,)
                             or bias.device != x.device):
        raise ValueError("the kernel takes a bf16 bias of one value a channel")
    weight = weight.contiguous()
    if weight.data_ptr() % 16:
        weight = weight.clone()
    if bias is not None:
        bias = bias.contiguous()
        if bias.data_ptr() % 16:
            bias = bias.clone()
    n, _, s1, s2, s3 = x.shape
    y = torch.empty((n, s1, s2, s3, c), dtype=x.dtype, device=x.device).permute(0, 4, 1, 2, 3)
    dims = array.array("q", [n, c, s1, s2, s3])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().cd_forward(x.data_ptr(), weight.data_ptr(),
                                int(weight.dtype == torch.bfloat16),
                                None if bias is None else bias.data_ptr(), y.data_ptr(),
                                dims.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"depthwise-convolution kernel launch failed: CUDA error {err}")
    conv_depthwise.launches += 1
    return y


conv_depthwise.launches = 0
