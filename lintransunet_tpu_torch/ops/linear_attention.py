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

The kernels take each (B, H, N, d) tensor in one of three layouts:
contiguous; the head-split view ``t.view(B, N, H, d).transpose(1, 2)`` of a
contiguous (B, N, H*d) projection, which is how the model passes them (no
copies); or the head-split view of one third of a contiguous (B, N, 3*H*d)
fused QKV projection (``split_qkv``: head stride d, token stride 3*H*d). The
outputs and gradients are allocated in the layout of ``query`` where query
is contiguous, else as the head-split view of a new contiguous (B, N, H*d)
tensor, and the kernels are given each output's own strides.
``linear_attention_qkv(qkv, heads)`` is the fused projection's entry: one
autograd node on the (B, N, 3*H*d) tensor, whose backward has the kernel
write dq, dk and dv into the three thirds of one new (B, N, 3*H*d) buffer,
the gradient of ``qkv`` itself, so that nothing assembles the three (the
alternative, three (B, N, H*d) gradients, would leave autograd one
concatenation of them a call). d is
2, 4 or a multiple of 8 up to 32 (``HEAD_WIDTHS``): the flagship's heads are
32 wide, ``SkipTransUnet``'s 2 to 32, ``MaskSkipTransUnet``'s 16.
"""

import array
import functools
import math
import operator

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
    contiguous (B, H, N, d), the head-split view of a contiguous (B, N, H*d)
    tensor, or the head-split view of a third of a contiguous (B, N, 3*H*d)
    one (a dimension of size 1 may have any stride)."""
    return None if t.data_ptr() % row_alignment(t) else _layout(t, *t.shape)


def _layout(t, b, h, n, d):
    sb, sh, sn, sf = t.stride()
    if sf != 1:
        return None
    # (batch, head, token) strides: contiguous, head-split, head-split of packed QKV
    for layout in ((h * n * d, n * d, d), (n * h * d, d, h * d), (3 * n * h * d, d, 3 * h * d)):
        if all(size == 1 or got == want
               for size, got, want in zip((b, h, n), (sb, sh, sn), layout)):
            return sb, sh, sn
    return None


def split_qkv(qkv: torch.Tensor, heads: int):
    """(B, N, 3*H*d) -> the (B, H, N, d) head-split views of its three
    thirds, q, k and v, without a copy."""
    b, n, width = qkv.shape
    if width % (3 * heads):
        raise ValueError(f"a fused QKV projection of width {width} does not split into "
                         f"3 x {heads} heads")
    return qkv.view(b, n, 3, heads, width // (3 * heads)).permute(2, 0, 3, 1, 4).unbind(0)


def _empty_out(t: torch.Tensor) -> torch.Tensor:
    """An output of t's shape and dtype: in t's layout where t is
    contiguous, else the head-split view of a new contiguous (B, N, H*d)
    tensor."""
    if t.is_contiguous():
        return torch.empty_like(t)
    b, h, n, d = t.shape
    return t.new_empty((b, n, h, d)).transpose(1, 2)


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
                f"view of a contiguous (B, N, H*d) tensor or of a third of a contiguous "
                f"(B, N, 3*H*d) one, aligned to {row_alignment(t)} bytes; got strides "
                f"{t.stride()} at {t.data_ptr():#x}")
        strides += s
    return strides


def _lib():
    global _library
    if _library is None:
        from lintransunet_tpu_torch import kernels

        _library = kernels.load("linear_attention")
    return _library


def _plan(inputs, outputs):
    """(plan, bh, scratch floats, row alignment) of a call on q, k, v (, g)
    writing ``outputs`` (out, or dq, dk, dv): ``lta_call``'s sizes and each
    tensor's strides, the outputs' their own. The tensors are checked and
    the plan built once per signature (each input's shape, strides, dtype
    and device, each output's strides); a call with a known signature checks
    only its pointers' alignment (``_run``)."""
    signature = tuple([(t.shape, t.stride(), t.dtype, t.get_device()) for t in inputs]
                      + [t.stride() for t in outputs])
    plan = _plans.get(signature)
    if plan is None:
        strides = _check_cuda_inputs(*inputs, *outputs)
        b, h, n, d = inputs[0].shape
        backward = len(inputs) == 4
        plan = _plans[signature] = (
            array.array("q", [int(backward), int(inputs[0].dtype == torch.bfloat16), b * h, h,
                              n, d] + strides),
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
    kernels' two launches (``planned`` is ``_plan(inputs, outputs)``)."""
    plan, bh, floats, align = planned
    ptrs = [t.data_ptr() for t in inputs + outputs]
    if functools.reduce(operator.or_, ptrs) % align:  # the plan checked everything else
        raise ValueError(f"the CUDA kernel takes tensors aligned to {align} bytes")
    device = inputs[0].get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)
    previous = torch._C._cuda_getDevice()
    if device != previous:
        torch.cuda.set_device(device)
    try:
        tickets, scratch = _workspace(device, stream, bh, floats)
        call = array.array("q", [stream, tickets, scratch] + ptrs)
        err = _library.lta_call(call.buffer_info()[0], plan.buffer_info()[0])
    finally:
        if device != previous:
            torch.cuda.set_device(previous)
    if err != 0:
        raise RuntimeError(f"linear-attention kernel launch failed: CUDA error {err}")


def _forward_kernel(query, key, value):
    inputs, outputs = (query, key, value), (_empty_out(query),)
    _run(_plan(inputs, outputs), inputs, outputs)
    linear_attention.launches += 1
    return outputs[0]


def linear_attention_backward(query: torch.Tensor, key: torch.Tensor,
                              value: torch.Tensor, grad: torch.Tensor, out=None):
    """(dq, dk, dv), semantics of ``linear_attention_backward_reference``.
    CPU tensors take the plain version; CUDA tensors launch the backward
    kernel, which writes the gradients into ``out`` (three (B, H, N, d)
    tensors in a layout the kernel takes) or into new tensors laid out as
    ``_empty_out(query)``. ``linear_attention_backward.launches`` counts its
    calls (two CUDA launches each)."""
    if not query.is_cuda:
        if query.device.type != "cpu":
            raise ValueError(f"no linear-attention path for {query.device}")
        grads = linear_attention_backward_reference(query, key, value, grad)
        if out is None:
            return grads
        for o, g in zip(out, grads):
            o.copy_(g)
        return tuple(out)
    inputs = (query, key, value, grad)
    grads = tuple(out) if out is not None else tuple(_empty_out(query) for _ in range(3))
    _run(_plan(inputs, grads), inputs, grads)
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


class PackedLinearAttentionFunction(torch.autograd.Function):
    """Linear attention on the three thirds of one fused (B, N, 3*H*d) QKV
    projection, CUDA only: the forward kernel reads q, k and v in place
    (``split_qkv``) and saves the projection; the backward kernel writes dq,
    dk and dv into the thirds of one new (B, N, 3*H*d) tensor, the
    projection's gradient."""

    @staticmethod
    def forward(ctx, qkv, heads):
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return _forward_kernel(*split_qkv(qkv, heads))

    @staticmethod
    def backward(ctx, grad):
        (qkv,) = ctx.saved_tensors
        if layout_strides(grad) is None:
            grad = grad.contiguous()
        d_qkv = torch.empty_like(qkv)  # contiguous, as the forward's plan required of qkv
        linear_attention_backward(*split_qkv(qkv, ctx.heads), grad,
                                  out=split_qkv(d_qkv, ctx.heads))
        return d_qkv, None


def linear_attention_qkv(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """``linear_attention(*split_qkv(qkv, heads))`` for a fused (B, N, 3*H*d)
    QKV projection, contiguous: on CUDA tensors no copy of q, k or v, two
    launches a call each way (``PackedLinearAttentionFunction`` when a
    gradient is wanted); on CPU tensors the plain version, which autograd
    differentiates. The output is the head-split view of a (B, N, H*d)
    tensor."""
    if not qkv.is_cuda:
        return linear_attention(*split_qkv(qkv, heads))
    if torch.is_grad_enabled() and qkv.requires_grad:
        return PackedLinearAttentionFunction.apply(qkv, heads)
    return _forward_kernel(*split_qkv(qkv, heads))


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
