"""Fused transformer stack: the CUDA kernel, its plain version, the wrapper.

Port of ``lintransunet_tpu/ops/pallas_layer.py``: ``stack_layer_params``,
``fused_transformer_stack`` (the Pallas kernel ``_make_kernel``) and
``fused_stack_reference``. A stack is L post-LN linear-attention layers
(``SelfAttentionLayer``) run on ``(B, N, C)`` tokens in eval, with d_k 32.

``fused_transformer_stack`` dispatches on the device of its tokens: CPU
tensors go to ``fused_transformer_stack_reference``; CUDA tensors launch
``csrc/fused_stack.cu`` or raise. The kernel takes the f32 weights; in bf16
it first rounds and packs them for the tensor cores into scratch. Eval only:
the kernel has no backward, as in JAX.
"""

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

D_K = 32        # kDk in csrc/fused_stack.cu: one feature per warp lane
WIDTHS = (32, 64, 128, 256)  # token widths C the kernel takes
LN_EPS = 1e-6


def stack_layer_params(layers: Sequence[torch.nn.Module]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[SelfAttentionLayer] -> (A, w2, vecs), f32, in the JAX layout:
    A (L, C, 6C) columns [Wq | Wk | Wv | Wo | W1 (2C)] as (in, out)
    matrices; w2 (L, 2C, C); vecs (L, 16, 2C) rows [bq, bk, bv, bo, b1 (2C),
    b2, ln1 scale, ln1 bias, ln2 scale, ln2 bias, zeros]."""
    As, w2s, vecs = [], [], []
    for layer in layers:
        lin = [getattr(layer.self_attn, f"linears_{i}") for i in range(4)]
        c = lin[0].weight.shape[0]
        As.append(torch.cat([m.weight.t() for m in lin]
                            + [layer.linear1.weight.t()], dim=1))
        w2s.append(layer.linear2.weight.t())
        vec = lin[0].weight.new_zeros((16, 2 * c))
        vec[0:4, :c] = torch.stack([m.bias for m in lin])
        vec[4] = layer.linear1.bias
        vec[5:10, :c] = torch.stack([
            layer.linear2.bias, layer.layer_norm1.weight, layer.layer_norm1.bias,
            layer.layer_norm2.weight, layer.layer_norm2.bias])
        vecs.append(vec)
    return (torch.stack(As).float().detach(), torch.stack(w2s).float().detach(),
            torch.stack(vecs).float().detach())


def fused_transformer_stack_reference(x: torch.Tensor, A: torch.Tensor,
                                      w2: torch.Tensor, vecs: torch.Tensor,
                                      n_heads: int) -> torch.Tensor:
    """Plain PyTorch version (``fused_stack_reference``): every layer in
    f32, the tokens stored in x's dtype after each layer."""
    b, n, c = x.shape
    d_k = c // n_heads

    def split(t):
        return t.reshape(b, n, n_heads, d_k).transpose(1, 2)

    out = x
    for l in range(A.shape[0]):
        a, vec = A[l].float(), vecs[l].float()
        xf = out.float()
        q, k, v = (xf @ a[:, i * c:(i + 1) * c] + vec[i, :c] for i in range(3))
        qh = torch.softmax(split(q), dim=-1) / math.sqrt(d_k)
        kh = torch.softmax(split(k), dim=-2)
        ctx = kh.transpose(-1, -2) @ split(v)
        attn = (qh @ ctx).transpose(1, 2).reshape(b, n, c)
        o = attn @ a[:, 3 * c:4 * c] + vec[3, :c]
        x1 = F.layer_norm(xf + o, (c,), vec[6, :c], vec[7, :c], LN_EPS)
        h = F.gelu(x1 @ a[:, 4 * c:] + vec[4])
        x2 = F.layer_norm(x1 + h @ w2[l].float() + vec[5, :c], (c,),
                          vec[8, :c], vec[9, :c], LN_EPS)
        out = x2.to(x.dtype)
    return out


def _check_cuda_inputs(x, A, w2, vecs, n_heads):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C); got {tuple(x.shape)}")
    b, n, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, not {x.dtype}")
    if c not in WIDTHS or c != D_K * n_heads:
        raise ValueError(f"the CUDA kernel takes C in {WIDTHS} with d_k = {D_K}; "
                         f"got C={c}, {n_heads} heads")
    if n < 1 or b > 65535:
        raise ValueError(f"the CUDA kernel takes 1 <= N and B <= 65535; got {(b, n)}")
    layers = A.shape[0] if A.dim() == 3 else -1
    want = {"A": (layers, c, 6 * c), "w2": (layers, 2 * c, c), "vecs": (layers, 16, 2 * c)}
    for name, t in (("A", A), ("w2", w2), ("vecs", vecs)):
        if tuple(t.shape) != want[name] or layers < 1:
            raise ValueError(f"{name} must be {want[name]}; got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, not {t.dtype}")
        if t.device != x.device:
            raise ValueError("x and the stacked parameters must share one device")
    if not all(t.is_contiguous() for t in (x, A, w2, vecs)):
        raise ValueError("the CUDA kernel takes contiguous tokens and parameters")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, A, w2, vecs)):
        raise NotImplementedError(
            "the CUDA transformer stack is eval-only (no backward), as in the "
            "JAX package")


def scratch_shapes(b: int, c: int, layers: int, tiles: int, is_bf16: int
                   ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """name -> (shape, dtype) of the kernel's scratch for ``tiles`` token
    tiles (``fst_num_tiles``): the tiles' K-softmax partials, the combined
    ctx / s and, in bf16, the weights packed for the tensor cores (each
    layer's A then its w2, 8 C^2 bf16)."""
    shapes = {"part_m": ((b, tiles, c), torch.float32),
              "part_s": ((b, tiles, c), torch.float32),
              "part_ctx": ((b, tiles, c, D_K), torch.float32),
              "ctxn": ((b, c, D_K), torch.float32)}
    if is_bf16:
        shapes["packed"] = ((layers, 8 * c * c), torch.bfloat16)
    return shapes


def fused_transformer_stack(x: torch.Tensor, A: torch.Tensor, w2: torch.Tensor,
                            vecs: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, N, C) tokens through the L layers of ``stack_layer_params``
    output; semantics of ``fused_transformer_stack_reference``, with the
    products' operands in x's dtype on the card, as the TPU kernel.
    ``fused_transformer_stack.launches`` counts kernel launches (one per
    call; CPU calls do not count)."""
    if x.device.type == "cpu":
        return fused_transformer_stack_reference(x, A, w2, vecs, n_heads)
    if x.device.type != "cuda":
        raise ValueError(f"no fused-stack path for {x.device}")
    _check_cuda_inputs(x, A, w2, vecs, n_heads)

    from lintransunet_tpu_torch import kernels

    lib = kernels.load("fused_stack")
    b, n, c = x.shape
    is_bf16 = int(x.dtype == torch.bfloat16)
    out = torch.empty_like(x)
    scratch = {name: torch.empty(shape, dtype=dtype, device=x.device) for name, (shape, dtype)
               in scratch_shapes(b, c, A.shape[0], lib.fst_num_tiles(n, is_bf16),
                                 is_bf16).items()}
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fst_forward(
            x.data_ptr(), out.data_ptr(), A.data_ptr(), w2.data_ptr(), vecs.data_ptr(),
            *(scratch[name].data_ptr() if name in scratch else None
              for name in ("packed", "part_m", "part_s", "part_ctx", "ctxn")),
            b, n, c, n_heads, A.shape[0], is_bf16, stream)
    if err != 0:
        raise RuntimeError(f"fused-stack kernel launch failed: CUDA error {err}")
    fused_transformer_stack.launches += 1
    return out


fused_transformer_stack.launches = 0
