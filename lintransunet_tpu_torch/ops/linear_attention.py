"""Fused linear attention: the CUDA kernels, their plain versions, the wrappers.

Port of ``lintransunet_tpu/ops/pallas_attention.py``. The forward kernel
(``csrc/linear_attention.cu``) replaces both Pallas forms, whole-N and
token-tiled, with one split-N design; the backward kernel in the same file
replaces the custom VJP ``_bwd``. The file's header says why each is built
as it is.

``linear_attention`` dispatches on the device of its inputs: CPU tensors go
to ``linear_attention_reference`` (autograd differentiates its plain ops);
CUDA tensors launch the forward kernel, through ``LinearAttentionFunction``
when a gradient is wanted, whose backward launches the backward kernel
(``linear_attention_backward``). Nothing catches a build or launch failure
and carries on.
"""

import math

import torch

MAX_D = 32  # kMaxD in csrc/linear_attention.cu: one feature per warp lane


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


def _check_cuda_inputs(*tensors):
    query = tensors[0]
    if query.dim() != 4 or any(t.shape != query.shape for t in tensors):
        raise ValueError(f"q, k, v (and the gradient) must share one (B, H, N, d) "
                         f"shape; got {[tuple(t.shape) for t in tensors]}")
    if query.shape[-1] > MAX_D or query.shape[-1] < 1:
        raise ValueError(f"the CUDA kernel takes 1 <= d == d_v <= {MAX_D}; "
                         f"got d={query.shape[-1]}")
    if query.shape[2] < 1:
        raise ValueError("the CUDA kernel needs at least one token")
    for t in tensors:
        if t.device != query.device or t.dtype != query.dtype:
            raise ValueError("q, k, v (and the gradient) must share one device "
                             "and dtype")
    if query.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, "
                        f"not {query.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel takes contiguous q, k, v")


def _launch_setup(query):
    from lintransunet_tpu_torch import kernels

    lib = kernels.load("linear_attention")
    b, h, n, d = query.shape
    n_split = lib.lta_num_splits(n)
    if n_split > 65535:
        raise ValueError(f"N={n} exceeds the kernel's grid limit")
    return lib, b * h, n, d, n_split, dict(dtype=torch.float32, device=query.device)


def _forward_kernel(query, key, value):
    _check_cuda_inputs(query, key, value)
    lib, bh, n, d, n_split, f32 = _launch_setup(query)
    out = torch.empty_like(query)
    part_m = torch.empty((bh, n_split, d), **f32)
    part_s = torch.empty((bh, n_split, d), **f32)
    part_ctx = torch.empty((bh, n_split, d, d), **f32)
    ctx = torch.empty((bh, d, d), **f32)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.lta_forward(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_s.data_ptr(), part_ctx.data_ptr(),
            ctx.data_ptr(), bh, n, d, int(query.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"linear-attention kernel launch failed: CUDA "
                           f"error {err}")
    linear_attention.launches += 1
    return out


def linear_attention_backward(query: torch.Tensor, key: torch.Tensor,
                              value: torch.Tensor, grad: torch.Tensor):
    """(dq, dk, dv), semantics of ``linear_attention_backward_reference``.
    CPU tensors take the plain version; CUDA tensors launch the backward
    kernel. ``linear_attention_backward.launches`` counts its launches."""
    if query.device.type == "cpu":
        return linear_attention_backward_reference(query, key, value, grad)
    if query.device.type != "cuda":
        raise ValueError(f"no linear-attention path for {query.device}")
    _check_cuda_inputs(query, key, value, grad)
    lib, bh, n, d, n_split, f32 = _launch_setup(query)
    dq, dk, dv = (torch.empty_like(query) for _ in range(3))
    part_m = torch.empty((bh, n_split, d), **f32)
    part_s = torch.empty((bh, n_split, d), **f32)
    part_c = torch.empty((bh, n_split, d, d), **f32)
    part_d = torch.empty((bh, n_split, d, d), **f32)
    state = torch.empty((bh, lib.lta_state_floats()), **f32)
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream(query.device).cuda_stream
        err = lib.lta_backward(
            query.data_ptr(), key.data_ptr(), value.data_ptr(), grad.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), part_m.data_ptr(),
            part_s.data_ptr(), part_c.data_ptr(), part_d.data_ptr(),
            state.data_ptr(), bh, n, d, int(query.dtype == torch.bfloat16),
            stream)
    if err != 0:
        raise RuntimeError(f"linear-attention backward kernel launch failed: "
                           f"CUDA error {err}")
    linear_attention_backward.launches += 1
    return dq, dk, dv


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
        return linear_attention_backward(query, key, value, grad.contiguous())


def linear_attention(query: torch.Tensor, key: torch.Tensor,
                     value: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) x3 -> (B, H, N, d); semantics of
    ``linear_attention_reference``. ``linear_attention.launches`` counts the
    forward kernel's launches (CPU calls do not count)."""
    if query.device.type == "cpu":
        return linear_attention_reference(query, key, value)
    if query.device.type != "cuda":
        raise ValueError(f"no linear-attention path for {query.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (query, key, value)):
        return LinearAttentionFunction.apply(query, key, value)
    return _forward_kernel(query, key, value)


linear_attention.launches = 0
linear_attention_backward.launches = 0
