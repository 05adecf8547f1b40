"""Fused stride-1 conv unit: the CUDA kernel, its plain version, the wrapper.

Port of ``lintransunet_tpu/ops/pallas_conv.py``: ``fused_s1_canvas`` (the
Pallas kernel ``_build_kernel``), ``stats_to_affine`` and
``apply_affine_leaky``, on the port's ``(N, C, H, W, D)`` tensors and
``(O, C, 3, 3, 3)`` weights. One unit is a 3x3x3 stride-1 convolution with
padding 1 whose prologue applies the previous InstanceNorm + LeakyReLU as a
per-(volume, channel) affine, which can take a second input (the UpBlock's
skip concat, never materialised), and whose epilogue sums the stored output
and its square per (volume, channel) for the next InstanceNorm. The canvas,
packed, folded and paired layouts the TPU kernel ran on are not ported.

Operand dtype, as in the JAX package: ``fused_s1_canvas`` rounds its
operands to bf16 unless ``compute_dtype`` says otherwise, and none of its
model callers says otherwise, so even an f32 model computes the fused
conv's products in bf16. ``conv_unit`` keeps that default; its output and
``z`` keep the input's dtype.

``conv_unit`` dispatches on the device of its inputs: CPU tensors go to
``conv_unit_reference``; CUDA tensors launch ``csrc/conv_unit.cu`` or raise.
With bf16 operands (the default) the wrapper first packs the weights with
``pack_weights``, once per call: the kernel keeps them resident in shared
memory. Eval only: the kernel has no backward, as in JAX.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_SLOPE = 0.01  # torch nn.LeakyReLU default, the reference's activation
K_CHUNK = 16      # input channels per K chunk of the bf16 kernel


def block_outputs(n_out: int) -> int:
    """Output channels per block of the bf16 kernel (``block_outputs`` in
    ``csrc/conv_unit.cu``, which refuses packed weights laid out otherwise)."""
    return 16 if n_out <= 16 else 32


def pack_weights(wa: torch.Tensor, wb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The bf16 kernel's weights: (O, Ca, 3, 3, 3) [and (O, Cb, 3, 3, 3)]
    f32 -> bf16 (G, K / 16, 27, 16, NT), indexed [output tile, K chunk, tap
    (kh, kw, kd), input channel in the chunk, output channel in the tile],
    NT = ``block_outputs(O)``. Each input's channels are zero-padded to a
    multiple of 16, xa's chunks first; the outputs to G * NT."""
    n_out = wa.shape[0]
    nt = block_outputs(n_out)
    parts = [F.pad(w.reshape(n_out, w.shape[1], 27), (0, 0, 0, -w.shape[1] % K_CHUNK))
             for w in (wa, wb) if w is not None]
    groups = -(-n_out // nt)
    w = F.pad(torch.cat(parts, dim=1), (0, 0, 0, 0, 0, groups * nt - n_out))
    k = w.shape[1]
    return (w.reshape(groups, nt, k // K_CHUNK, K_CHUNK, 27).permute(0, 2, 4, 3, 1)
            .to(torch.bfloat16).contiguous())


def stats_to_affine(stats: torch.Tensor, count: int,
                    eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 2, C) f32 sums of y and y^2 over ``count`` voxels -> the
    InstanceNorm of y as a per-(volume, channel) affine: (scale, shift),
    each (N, C) f32, with normalise(y) = y * scale + shift. Single-pass
    variance, clamped at 0, as ``pallas_conv.stats_to_affine``."""
    mean = stats[:, 0] / count
    var = (stats[:, 1] / count - mean.square()).clamp_min(0.0)
    scale = torch.rsqrt(var + eps)
    return scale, -mean * scale


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None, None]


def apply_affine_leaky(y: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(y * scale + shift) in f32, in y's dtype: the InstanceNorm
    + LeakyReLU at the end of a chain of units."""
    z = y.float() * _per_channel(scale) + _per_channel(shift)
    return F.leaky_relu(z, NEG_SLOPE).to(y.dtype)


def _prologue(x: torch.Tensor, affine: Optional[torch.Tensor],
              compute_dtype: torch.dtype) -> torch.Tensor:
    if affine is None:
        return x.to(compute_dtype)
    return apply_affine_leaky(x.float(), affine[:, 0], affine[:, 1]).to(compute_dtype)


def _outputs(y, stats, z, want_stats, want_z):
    outs = (y,) + ((stats,) if want_stats else ()) + ((z,) if want_z else ())
    return outs if len(outs) > 1 else y


def conv_unit_reference(xa, wa, xb=None, wb=None, bias=None, affine_a=None,
                        affine_b=None, want_stats=True, want_z=False,
                        compute_dtype=None):
    """Plain PyTorch version of :func:`conv_unit`: the prologue
    act(x * scale + shift) rounded to ``compute_dtype``, zero padding
    outside the volume, ``F.conv3d`` of the concat in f32 on the rounded
    operands, bias, the output rounded to xa's dtype, and f32 sums of it."""
    cdt = compute_dtype or torch.bfloat16
    a = _prologue(xa, affine_a, cdt)
    x, w = a, wa
    if xb is not None:
        x = torch.cat([a, _prologue(xb, affine_b, cdt)], dim=1)
        w = torch.cat([wa, wb], dim=1)
    acc = F.conv3d(x.float(), w.to(cdt).float(), None, 1, 1)
    if bias is not None:
        acc = acc + bias.float()[None, :, None, None, None]
    y = acc.to(xa.dtype)
    stats = None
    if want_stats:
        y32 = y.float()
        stats = torch.stack([y32.sum(dim=(2, 3, 4)),
                             y32.square().sum(dim=(2, 3, 4))], dim=1)
    return _outputs(y, stats, a.to(xa.dtype), want_stats, want_z)


def _check_weight(w: torch.Tensor, n_out: Optional[int], c: int, what: str):
    if w.dim() != 5 or tuple(w.shape[1:]) != (c, 3, 3, 3):
        raise ValueError(f"{what} must be (O, {c}, 3, 3, 3); got {tuple(w.shape)}")
    if n_out is not None and w.shape[0] != n_out:
        raise ValueError(f"{what} has {w.shape[0]} output channels, not {n_out}")
    if w.dtype != torch.float32:
        raise TypeError(f"{what} must be float32 (the kernel rounds it), not {w.dtype}")
    if w.stride()[1:] != (27, 9, 3, 1):
        raise ValueError(f"{what} must be contiguous past its first dim")


def _check_activation(x: torch.Tensor, like: Optional[torch.Tensor], what: str):
    if x.dim() != 5:
        raise ValueError(f"{what} must be (N, C, H, W, D); got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, not {x.dtype}")
    if like is not None and (x.shape[0] != like.shape[0] or x.shape[2:] != like.shape[2:]
                             or x.dtype != like.dtype):
        raise ValueError(f"{what} {tuple(x.shape)} {x.dtype} does not match xa "
                         f"{tuple(like.shape)} {like.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"the CUDA kernel takes a contiguous {what}")


def _check_vector(v: torch.Tensor, shape, what: str):
    if tuple(v.shape) != shape or v.dtype != torch.float32 or not v.is_contiguous():
        raise ValueError(f"{what} must be a contiguous f32 tensor of shape {shape}; got "
                         f"{tuple(v.shape)} {v.dtype}")


def _check_cuda_inputs(xa, wa, xb, wb, bias, affine_a, affine_b, compute_dtype):
    _check_activation(xa, None, "xa")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"the CUDA kernel computes in float32 or bfloat16, "
                         f"not {compute_dtype}")
    n, ca = xa.shape[:2]
    if n > 65535:
        raise ValueError(f"N={n} exceeds the kernel's grid limit")
    _check_weight(wa, None, ca, "wa")
    if (xb is None) != (wb is None):
        raise ValueError("xb and wb go together")
    tensors = [xa, wa]
    if xb is not None:
        _check_activation(xb, xa, "xb")
        _check_weight(wb, wa.shape[0], xb.shape[1], "wb")
        tensors += [xb, wb]
    if bias is not None:
        _check_vector(bias, (wa.shape[0],), "bias")
        tensors.append(bias)
    for affine, x, what in ((affine_a, xa, "affine_a"), (affine_b, xb, "affine_b")):
        if affine is not None:
            if x is None:
                raise ValueError(f"{what} without its input")
            _check_vector(affine, (n, 2, x.shape[1]), what)
            tensors.append(affine)
    if any(t.device != xa.device for t in tensors):
        raise ValueError("every input must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the CUDA conv unit is eval-only (no backward), as in the JAX package")


def conv_unit(xa: torch.Tensor, wa: torch.Tensor,
              xb: Optional[torch.Tensor] = None, wb: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              affine_a: Optional[torch.Tensor] = None,
              affine_b: Optional[torch.Tensor] = None, want_stats: bool = True,
              want_z: bool = False, compute_dtype: Optional[torch.dtype] = None):
    """3x3x3 stride-1 conv (padding 1) of act(xa) [and act(xb)] with wa
    [and wb], plus bias.

    xa: (N, Ca, H, W, D); wa: (O, Ca, 3, 3, 3) f32; xb / wb: the optional
    second input and its weights (the concat's later channels); affine_*:
    (N, 2, C) f32 (scale, shift) of act(x * scale + shift), act =
    LeakyReLU(0.01). Returns y (N, O, H, W, D) in xa's dtype, then
    ``stats`` (N, 2, O) f32 (sums of y as stored and of y^2) if
    ``want_stats``, then ``z`` = act(xa) if ``want_z``; y alone if neither.
    The operands act(x) and the weights are rounded to ``compute_dtype``
    (default bf16, as JAX's ``fused_s1_canvas``); products sum in f32.
    ``conv_unit.launches`` counts kernel launches (CPU calls do not count).
    """
    if xa.device.type == "cpu":
        return conv_unit_reference(xa, wa, xb, wb, bias, affine_a, affine_b,
                                   want_stats, want_z, compute_dtype)
    if xa.device.type != "cuda":
        raise ValueError(f"no conv-unit path for {xa.device}")
    _check_cuda_inputs(xa, wa, xb, wb, bias, affine_a, affine_b, compute_dtype)

    from lintransunet_tpu_torch import kernels

    lib = kernels.load("conv_unit")
    n, ca, h, w, d = xa.shape
    cb = 0 if xb is None else xb.shape[1]
    n_out = wa.shape[0]
    is_bf16 = int(xa.dtype == torch.bfloat16)
    compute_bf16 = int(compute_dtype in (None, torch.bfloat16))
    y = torch.empty((n, n_out, h, w, d), dtype=xa.dtype, device=xa.device)
    z = torch.empty_like(xa) if want_z else None
    packed = pack_weights(wa, wb) if compute_bf16 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(xa.device):
        stats = part = None
        if want_stats:
            partials = lib.cu_num_partials(n, ca, cb, n_out, h, w, d, is_bf16, compute_bf16)
            if partials < 1:
                raise RuntimeError(f"conv-unit kernel plan failed: CUDA error {-partials}")
            f32 = dict(dtype=torch.float32, device=xa.device)
            part = torch.empty((n, partials, 2, n_out), **f32)
            stats = torch.empty((n, 2, n_out), **f32)
        stream = torch.cuda.current_stream(xa.device).cuda_stream
        err = lib.cu_forward(
            ptr(xa), ptr(wa), wa.stride(0) // 27, ptr(affine_a), ca,
            ptr(xb), ptr(wb), 0 if wb is None else wb.stride(0) // 27, ptr(affine_b), cb,
            ptr(packed), block_outputs(n_out), ptr(bias), ptr(y), ptr(z), ptr(part),
            ptr(stats), n, n_out, h, w, d, is_bf16, compute_bf16, stream)
    if err != 0:
        raise RuntimeError(f"conv-unit kernel launch failed: CUDA error {err}")
    conv_unit.launches += 1
    return _outputs(y, stats, z, want_stats, want_z)


conv_unit.launches = 0
