"""Fused linear attention: the CUDA kernels, their plain versions, the wrappers.

Port of ``lintransunet_tpu/ops/pallas_attention.py``. The forward kernel
(``csrc/linear_attention.cu``) replaces both Pallas forms, whole-N and
token-tiled, with one design: a fold over token tiles whose last block per
slice merges the partials, then a token kernel; the backward kernel in the
same file replaces the custom VJP ``_bwd``. Each call is two launches. The
file's header says why each is built as it is.

``linear_attention`` dispatches on the device of its inputs: CPU tensors go
to ``linear_attention_reference`` (autograd differentiates its plain ops);
CUDA tensors launch the forward kernel, through ``LinearAttentionFunction``
when a gradient is wanted, whose backward launches the backward kernel
(``linear_attention_backward``). Nothing catches a build or launch failure
and carries on.

The kernels take each (B, H, N, d) tensor in one of two layouts: contiguous,
or the head-split view ``t.view(B, N, H, d).transpose(1, 2)`` of a
contiguous (B, N, H*d) projection, which is how the model passes them (no
copies). Outputs and gradients come out in the layout of ``query``. d is
2, 4 or a multiple of 8 up to 32 (``HEAD_WIDTHS``): the flagship's heads are
32 wide, ``SkipTransUnet``'s 2 to 32, ``MaskSkipTransUnet``'s 16.
"""

import array
import math

import torch

HEAD_WIDTHS = (2, 4, 8, 16, 24, 32)  # the d the kernels take, up to kMaxD of the source

_library = None
_plans = {}       # signature of q, k, v (, g) -> (plan array, bh, scratch floats)
_workspaces = {}  # (device, stream) -> (buffer, tickets, floats, tickets ptr, scratch ptr)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 inside, or f64 for f64 inputs (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def linear_attention_reference(query: torch.Tensor, key: torch.Tensor,
                               value: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) x3 -> (B, H, N, d). Plain PyTorch, f32 inside, output in
    the input dtype: the semantics of the kernel (and of the Pallas one)."""
    acc = _acc_dtype(query.dtype)
    d_k = query.shape[-1]
    q = torch.softmax(query.to(acc), dim=-1) * (1.0 / math.sqrt(d_k))
    k = torch.softmax(key.to(acc), dim=-2)
    context = torch.matmul(k.transpose(-1, -2), value.to(acc))
    return torch.matmul(q, context).to(query.dtype)


def linear_attention_backward_reference(query: torch.Tensor, key: torch.Tensor,
                                        value: torch.Tensor, grad: torch.Tensor):
    """(dq, dk, dv) of ``linear_attention_reference`` for the output
    gradient ``grad``: ``_bwd``'s einsums (pallas_attention.py:260-290), f32
    inside, the softmaxes recomputed from q and k, gradients in the input
    dtype."""
    acc = _acc_dtype(query.dtype)
    scale = 1.0 / math.sqrt(query.shape[-1])
    g = grad.to(acc)
    s_q = torch.softmax(query.to(acc), dim=-1)
    s_k = torch.softmax(key.to(acc), dim=-2)
    v = value.to(acc)

    context = torch.matmul(s_k.transpose(-1, -2), v)              # (B, H, d, d)
    dq_prime = torch.matmul(g, context.transpose(-1, -2)) * scale
    dq = s_q * (dq_prime - (dq_prime * s_q).sum(dim=-1, keepdim=True))
    d_context = torch.matmul((s_q * scale).transpose(-1, -2), g)  # (B, H, d, d)
    dk_prime = torch.matmul(v, d_context.transpose(-1, -2))
    dk = s_k * (dk_prime - (dk_prime * s_k).sum(dim=-2, keepdim=True))
    dv = torch.matmul(s_k, d_context)
    return dq.to(query.dtype), dk.to(key.dtype), dv.to(value.dtype)


def row_alignment(t: torch.Tensor) -> int:
    """The bytes a head row of ``t`` must be aligned to: 16, or the row's
    own 4 or 8 bytes where it is narrower (d = 2, 4 in bf16, 2 in f32)."""
    return min(16, t.shape[-1] * t.element_size())


def layout_strides(t: torch.Tensor):
    """t's (batch, head, token) element strides if the kernels take its
    layout, else None: feature stride 1, aligned to ``row_alignment``, and
    either contiguous (B, H, N, d) or the head-split view of a contiguous
    (B, N, H*d) tensor (a dimension of size 1 may have any stride)."""
    return None if t.data_ptr() % row_alignment(t) else _layout(t, *t.shape)


def _layout(t, b, h, n, d):
    sb, sh, sn, sf = t.stride()
    if sf != 1:
        return None
    if ((b == 1 or sb == h * n * d) and (h == 1 or sh == n * d) and (n == 1 or sn == d)
            or (b == 1 or sb == n * h * d) and (h == 1 or sh == d) and (n == 1 or sn == h * d)):
        return sb, sh, sn
    return None


def _check_cuda_inputs(*tensors):
    """The kernels' arguments checked; returns the flat list of their
    (batch, head, token) strides."""
    query = tensors[0]
    shape, dtype, device = query.shape, query.dtype, query.get_device()
    if len(shape) != 4:
        raise ValueError(f"q, k, v (and the gradient) must be (B, H, N, d); got "
                         f"{[tuple(t.shape) for t in tensors]}")
    b, h, n, d = shape
    if d not in HEAD_WIDTHS:
        raise ValueError(f"the CUDA kernel takes d == d_v in {HEAD_WIDTHS}; got d={d}")
    if n < 1:
        raise ValueError("the CUDA kernel needs at least one token")
    if b * h > 65535:
        raise ValueError(f"B*H={b * h} exceeds the kernel's grid limit")
    for t in tensors:
        if t.shape != shape:
            raise ValueError(f"q, k, v (and the gradient) must share one (B, H, N, d) "
                             f"shape; got {[tuple(t.shape) for t in tensors]}")
        if t.dtype != dtype or t.get_device() != device:
            raise ValueError("q, k, v (and the gradient) must share one device and dtype")
    if dtype != torch.float32 and dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, not {dtype}")
    strides = []
    for t in tensors:
        s = layout_strides(t)
        if s is None:
            raise ValueError(
                f"the CUDA kernel takes (B, H, N, d) contiguous or as the head-split "
                f"view of a contiguous (B, N, H*d) tensor, aligned to {row_alignment(t)} "
                f"bytes; got strides {t.stride()} at {t.data_ptr():#x}")
        strides += s
    return strides


def _lib():
    global _library
    if _library is None:
        from lintransunet_tpu_torch import kernels

        _library = kernels.load("linear_attention")
    return _library


def _plan(inputs):
    """(plan, bh, scratch floats, row alignment) of a call on q, k, v (, g):
    ``lta_call``'s sizes and strides, outputs in the layout of q. The inputs are checked
    and the plan built once per signature (each input's shape, strides,
    dtype and device); a call with a known signature checks only its
    pointers' alignment (``_run``)."""
    signature = tuple([(t.shape, t.stride(), t.dtype, t.get_device()) for t in inputs])
    plan = _plans.get(signature)
    if plan is None:
        strides = _check_cuda_inputs(*inputs)
        b, h, n, d = inputs[0].shape
        backward = len(inputs) == 4
        outputs = strides[:3] * (3 if backward else 1)  # torch.empty_like(q) keeps its strides
        plan = _plans[signature] = (
            array.array("q", [int(backward), int(inputs[0].dtype == torch.bfloat16), b * h, h,
                              n, d] + strides + outputs),
            b * h, _lib().lta_scratch_floats(b * h, n, int(backward)),
            row_alignment(inputs[0]))
    return plan


def _workspace(device, stream, bh, floats):
    """(tickets, scratch) pointers of the stream's workspace, grown to what a
    call needs: one buffer per (device, stream), so a call allocates nothing
    but its outputs. Calls on one stream run in order, so they can share
    it; the tickets are zero between calls (the kernel leaves them so)."""
    space = _workspaces.get((device, stream))
    if space is None or space[1] < bh or space[2] < floats:
        tickets = -(-max(bh, 64, space[1] if space else 0) // 4) * 4  # scratch 16-byte aligned
        floats = max(floats, space[2] if space else 0)
        buf = torch.zeros(tickets + floats, dtype=torch.float32, device=device)
        space = _workspaces[(device, stream)] = (buf, tickets, floats, buf.data_ptr(),
                                                 buf.data_ptr() + 4 * tickets)
    return space[3], space[4]


def _run(planned, inputs, outputs):
    """``lta_call`` on the current stream of the inputs' device: the
    kernels' two launches (``planned`` is ``_plan(inputs)``)."""
    plan, bh, floats, align = planned
    ptrs = [t.data_ptr() for t in inputs]
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[-1]) % align:  # the plan checked everything else
        raise ValueError(f"the CUDA kernel takes tensors aligned to {align} bytes")
    device = inputs[0].get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    previous = torch._C._cuda_getDevice()
    if device != previous:
        torch.cuda.set_device(device)
    try:
        tickets, scratch = _workspace(device, stream, bh, floats)
        call = array.array("q", [stream, tickets, scratch] + ptrs
                           + [t.data_ptr() for t in outputs])
        err = _library.lta_call(call.buffer_info()[0], plan.buffer_info()[0])
    finally:
        if device != previous:
            torch.cuda.set_device(previous)
    if err != 0:
        raise RuntimeError(f"linear-attention kernel launch failed: CUDA error {err}")


def _forward_kernel(query, key, value):
    inputs = (query, key, value)
    plan = _plan(inputs)
    out = torch.empty_like(query)  # a dense view: query's strides
    _run(plan, inputs, (out,))
    linear_attention.launches += 1
    return out


def linear_attention_backward(query: torch.Tensor, key: torch.Tensor,
                              value: torch.Tensor, grad: torch.Tensor):
    """(dq, dk, dv), semantics of ``linear_attention_backward_reference``.
    CPU tensors take the plain version; CUDA tensors launch the backward
    kernel, and the gradients come out in the layout of ``query``.
    ``linear_attention_backward.launches`` counts its calls (two CUDA
    launches each)."""
    if not query.is_cuda:
        if query.device.type == "cpu":
            return linear_attention_backward_reference(query, key, value, grad)
        raise ValueError(f"no linear-attention path for {query.device}")
    inputs = (query, key, value, grad)
    plan = _plan(inputs)
    grads = (torch.empty_like(query), torch.empty_like(query), torch.empty_like(query))
    _run(plan, inputs, grads)
    linear_attention_backward.launches += 1
    return grads


class LinearAttentionFunction(torch.autograd.Function):
    """Linear attention with its hand-written backward. The forward saves
    q, k, v (as JAX's ``_fwd`` does) and nothing else. On CUDA tensors both
    directions launch the kernels; on CPU tensors both take the plain
    versions (``torch.autograd.gradcheck`` runs there in f64)."""

    @staticmethod
    def forward(ctx, query, key, value):
        ctx.save_for_backward(query, key, value)
        if query.device.type == "cpu":
            return linear_attention_reference(query, key, value)
        return _forward_kernel(query, key, value)

    @staticmethod
    def backward(ctx, grad):
        query, key, value = ctx.saved_tensors
        # The gradient is taken as it arrives (in the model, the head-split
        # view); only a layout the kernel does not take (an expanded one, say)
        # is copied.
        if grad.is_cuda and layout_strides(grad) is None:
            grad = grad.contiguous()
        return linear_attention_backward(query, key, value, grad)


def linear_attention(query: torch.Tensor, key: torch.Tensor,
                     value: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) x3 -> (B, H, N, d); semantics of
    ``linear_attention_reference``. ``linear_attention.launches`` counts the
    forward kernel's calls (two CUDA launches each; CPU calls do not
    count)."""
    if not query.is_cuda:
        if query.device.type == "cpu":
            return linear_attention_reference(query, key, value)
        raise ValueError(f"no linear-attention path for {query.device}")
    if torch.is_grad_enabled() and (query.requires_grad or key.requires_grad
                                    or value.requires_grad):
        return LinearAttentionFunction.apply(query, key, value)
    return _forward_kernel(query, key, value)


linear_attention.launches = 0
linear_attention_backward.launches = 0
