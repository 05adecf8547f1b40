"""Stride-1 bf16 3x3x3 convolutions with at most 8 outputs: the CUDA kernel,
its plain version, the routing and the autograd Function.

On the H100 cuDNN runs the decoders' final block (16 -> 8) and the ROI
decoder's mask heads (32-256 -> 2) on its tensor-core implicit GEMM with a
layout transpose on each side and the bias as a kernel of its own: 1.9 ms
of a flagship window for ~0.1 ms of compulsory traffic (PERF.md, section
6). ``routes`` picks such convolutions by what a call shows: a CUDA bf16
input of 5 dims whose depth the kernel's tiles take, groups 1, stride 1, a
3x3x3 kernel with padding 1 and at most ``MAX_OUT`` outputs. The 1x1x1
gates (``psi``, one output) stay on ``F.conv3d``: cuBLAS runs three of the
four faster than this design would (PERF.md). ``ops.conv3d`` sends the
routed calls here: under grad through ``NarrowConv3d``, whose forward is
the kernel and whose input, weight and bias gradients are cuDNN's as
autograd computes them for ``F.conv3d``; otherwise (serving) to
``conv_narrow`` directly. f32 models and CPU tensors do not route.

``conv_narrow`` dispatches on the device of its input: CPU tensors go to
``conv_narrow_reference`` (f32 ``F.conv3d`` of the bf16-rounded operands);
CUDA tensors launch ``csrc/conv_narrow.cu`` (two CUDA launches: the weights
packed into the kernel's B fragments, then the convolution) or raise.
``conv_narrow.launches`` counts its calls on the card. The kernel replaces
no TPU kernel: the JAX package left its convolutions to XLA.
"""

import array

import torch
import torch.nn.functional as F

MAX_OUT = 8     # outputs the kernel takes
MAX_DEPTH = 128  # depth (last dim) the kernel's tiles take, in steps of 8
CHUNK = 16      # input channels a K chunk of the kernel

_library = None


def _lib():
    global _library
    if _library is None:
        from lintransunet_tpu_torch import kernels

        _library = kernels.load("conv_narrow")
    return _library


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


def takes(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0, groups: int = 1) -> bool:
    """True where the kernel computes ``F.conv3d(x, weight, _, stride,
    padding, 1, groups)``, whatever the device: bf16 x of 5 dims with a
    depth that is a multiple of 8 up to ``MAX_DEPTH``, groups 1, stride 1,
    a 3x3x3 kernel with padding 1, at most ``MAX_OUT`` outputs."""
    if x.dtype != torch.bfloat16 or x.dim() != 5 or weight.dim() != 5 or groups != 1:
        return False
    return (tuple(weight.shape[2:]) == (3, 3, 3) and _triple(padding) == (1, 1, 1)
            and _triple(stride) == (1, 1, 1) and weight.shape[0] <= MAX_OUT
            and weight.shape[1] == x.shape[1]
            and x.shape[4] % 8 == 0 and 0 < x.shape[4] <= MAX_DEPTH)


def routes(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0, groups: int = 1) -> bool:
    """True where ``ops.conv3d(x, weight, ..., stride, padding, groups)``
    takes the kernel: a CUDA input that ``takes`` accepts."""
    return x.is_cuda and takes(x, weight, stride, padding, groups)


def conv_narrow_reference(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor = None) -> torch.Tensor:
    """The plain version: f32 ``F.conv3d`` of x, weight and bias rounded to
    bf16, stride 1, padding 1, the result in x's dtype."""
    def rounded(t):
        return None if t is None else t.to(torch.bfloat16).float()

    y = F.conv3d(rounded(x), rounded(weight), rounded(bias), 1, 1)
    return y.to(x.dtype)


def conv_narrow(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor = None) -> torch.Tensor:
    """``F.conv3d(x, weight.to(x.dtype), bias, 1, 1)`` for x (N, C, H, W, D)
    and weight (O, C, 3, 3, 3) that ``takes`` accepts; weight f32 or
    bf16 (rounded to bf16 as ``.to`` rounds), bias (O,) in x's dtype or
    None. bf16 products summed in f32, the output rounded to bf16 once."""
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no narrow-convolution path for {x.device}")
        return conv_narrow_reference(x, weight, bias)
    if not takes(x, weight, 1, 1):
        raise ValueError(f"the narrow-convolution kernel does not take x {tuple(x.shape)} "
                         f"{x.dtype} with weight {tuple(weight.shape)}")
    if weight.dtype not in (torch.float32, torch.bfloat16) or weight.device != x.device:
        raise ValueError("the kernel takes an f32 or bf16 weight on the input's device")
    if bias is not None and (bias.dtype != torch.bfloat16 or bias.shape != weight.shape[:1]
                             or bias.device != x.device):
        raise ValueError("the kernel takes a bf16 bias of one value an output")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    weight = weight.contiguous()
    n, c, h, w, d = x.shape
    o = weight.shape[0]
    frags = 27 if o > 2 else 9
    packed = torch.empty((-(-c // CHUNK), frags, 32, 2), dtype=torch.int32, device=x.device)
    y = torch.empty((n, o, h, w, d), dtype=x.dtype, device=x.device)
    bias_ptr = None if bias is None else bias.contiguous().data_ptr()
    dims = array.array("q", [n, c, o, h, w, d])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().cn_forward(x.data_ptr(), weight.data_ptr(),
                                int(weight.dtype == torch.bfloat16), packed.data_ptr(),
                                bias_ptr, y.data_ptr(), dims.buffer_info()[0], stream)
    if err != 0:
        raise RuntimeError(f"narrow-convolution kernel launch failed: CUDA error {err}")
    conv_narrow.launches += 1
    return y


conv_narrow.launches = 0


class NarrowConv3d(torch.autograd.Function):
    """``F.conv3d(x, w, bias, 1, 1)`` for a routed convolution (``routes``),
    w already in x's dtype, bias in x's dtype or None. The
    forward is ``conv_narrow``; the input, weight and bias gradients are
    cuDNN's ``convolution_backward``, with the output mask autograd gives
    ``F.conv3d``."""

    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.with_bias = bias is not None
        return conv_narrow(x, w, bias)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad, x, w, [w.shape[0]] if ctx.with_bias else None, [1, 1, 1], [1, 1, 1],
            [1, 1, 1], False, [0, 0, 0], 1, list(ctx.needs_input_grad))
        return gx, gw, gb


def conv3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor = None) -> torch.Tensor:
    """A routed convolution (``routes``) of ``ops.conv3d``, ``bias`` already
    in x's dtype: through ``NarrowConv3d`` where autograd records (its
    backward needs the weight in x's dtype), else the kernel straight from
    the weight as it is."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or (bias is not None and bias.requires_grad)):
        return NarrowConv3d.apply(x, weight.to(x.dtype), bias)
    return conv_narrow(x, weight, bias)
