"""A channels-last 3x3x3 conv from one staged halo tile: the H100
counterpart of ``experiments/pallas_conv_prototype.py`` (``pallas_conv`` ->
``kernel``, pallas_call at :90).

``conv3d_cl(x, k)`` is the stride-1, padding-1 convolution of x (H, W, D, C)
with k (3, 3, 3, C, O) (HWDIO), no bias, as the probe's reference
``jax.lax.conv_general_dilated(..., ('NHWDC', 'HWDIO', 'NHWDC'))`` (:117).
Design (``csrc/probe_conv.cu``, ``halo``): per chunk of input channels a
block stages its halo tile once and reads the 27 taps as shifted rows of
it. The TPU prototype's depth-parity fold (D pairs folded into 2C lanes to
fill 128 lanes, at twice the FLOPs) is not carried over.

bf16 operands sum in f32 and store bf16; f32 runs FMA in f32. CPU tensors
take ``conv3d_cl_reference``; CUDA tensors launch the kernel or raise.

``python -m lintransunet_tpu_torch.experiments.conv_prototype`` runs the
probe's shape (C = 64, 128 x 128 x 64) on the card, beside ``F.conv3d``.
"""

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.experiments import common

SHAPE = (128, 128, 64, 64)       # (H, W, D, C) of the TPU probe
N_OUT = 64


def conv3d_cl_reference(x, k, bias=None):
    """Plain PyTorch version: ``F.conv3d`` in f32 on channels-last tensors
    (x (N, H, W, D, C) or (H, W, D, C), k (3, 3, 3, C, O)), plus bias, in
    x's dtype."""
    single = x.dim() == 4
    xb = x[None] if single else x
    y = F.conv3d(xb.permute(0, 4, 1, 2, 3).float(), k.permute(4, 3, 0, 1, 2).float(),
                 None if bias is None else bias.float(), padding=1)
    y = y.permute(0, 2, 3, 4, 1).to(x.dtype)
    return y[0] if single else y


def library_conv(x, k_ncdhw, bias=None):
    """The yardstick: ``F.conv3d`` (cuDNN) on the same data as
    ``channels_last_3d`` tensors; x (N, H, W, D, C), k_ncdhw (O, C, 3, 3, 3)
    in channels_last_3d (``library_weight``), bias in x's dtype. The port
    never calls it."""
    return F.conv3d(x.permute(0, 4, 1, 2, 3), k_ncdhw, bias, padding=1)


def library_weight(k):
    return k.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)


def default_tile(d: int):
    """(th, tw): th * tw * D = 128 output positions per block."""
    if d % 16 or 128 % d:
        raise ValueError(f"D={d}: the kernel takes D in 16, 32, 64 or 128")
    return 1, 128 // d


def run_conv(x, k, bias, th, tw, rows):
    """Check CUDA inputs (x (N, H, W, D, C)) and launch ``probe_conv.cu``
    once (uncounted)."""
    from lintransunet_tpu_torch import kernels

    if x.dim() != 5 or k.dim() != 5 or tuple(k.shape[:4]) != (3, 3, 3, x.shape[4]):
        raise ValueError(f"x must be (N, H, W, D, C) and k (3, 3, 3, C, O); got "
                         f"{tuple(x.shape)}, {tuple(k.shape)}")
    tensors = [x, k] + ([] if bias is None else [bias])
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("every input must be on one CUDA device")
    if x.dtype not in (torch.bfloat16, torch.float32) or k.dtype != x.dtype:
        raise TypeError(f"the kernel takes bf16 or f32 x and k of one dtype; got "
                        f"{x.dtype}, {k.dtype}")
    if not (x.is_contiguous() and k.is_contiguous()):
        raise ValueError("the kernel takes contiguous x and k")
    n, h, w, d, c = x.shape
    o = k.shape[4]
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (o,)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous f32 ({o},) tensor")
    is_bf16 = x.dtype == torch.bfloat16
    if (th * tw * d != 128 or h % th or w % tw or d % 16 or o % 64
            or c % (32 if is_bf16 else 16) or n > 65535):
        raise ValueError(f"x {tuple(x.shape)} -> O={o} with th={th}, tw={tw}: the kernel "
                         f"takes th * tw * D = 128, th | H, tw | W, O % 64 == 0 and C % "
                         f"{32 if is_bf16 else 16} == 0")
    lib = kernels.load("probe_conv")
    smem = lib.pc_smem_bytes(d, th, tw, o, int(rows), int(is_bf16))
    if smem > common.SMEM_LIMIT:
        raise ValueError(f"th={th}, tw={tw}, D={d}, O={o} needs {smem} bytes of shared "
                         f"memory; a block has {common.SMEM_LIMIT}")
    out = torch.empty((n, h, w, d, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pc_forward(x.data_ptr(), k.data_ptr(),
                             None if bias is None else bias.data_ptr(), out.data_ptr(),
                             n, h, w, d, c, o, th, tw, int(rows), int(is_bf16), stream)
    if err != 0:
        raise RuntimeError(f"probe_conv kernel launch failed: CUDA error {err}")
    return out


def conv3d_cl(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3x3x3 conv, stride 1, padding 1, of x (H, W, D, C) with k (3, 3, 3,
    C, O): (H, W, D, O) in x's dtype (bf16 or f32). The kernel's tile is
    1 x (128 / D) x D positions. ``conv3d_cl.launches`` counts launches."""
    if x.device.type == "cpu":
        return conv3d_cl_reference(x, k)
    if x.dim() != 4:
        raise ValueError(f"x must be (H, W, D, C); got {tuple(x.shape)}")
    out = run_conv(x[None], k, None, *default_tile(x.shape[2]), rows=False)[0]
    conv3d_cl.launches += 1
    return out


conv3d_cl.launches = 0


def conv_costs(x, k, dtype=torch.bfloat16):
    """(FLOPs, compulsory bytes): x and k read once, the output written once."""
    voxels = x.numel() // x.shape[-1]
    c, o = k.shape[3], k.shape[4]
    size = torch.finfo(dtype).bits // 8
    return 2 * voxels * 27 * c * o, size * (x.numel() + k.numel() + voxels * o)


def inputs(shape, n_out, device, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(shape, generator=g).to(device, dtype)
    k = (torch.randn((3, 3, 3, shape[-1], n_out), generator=g) * 0.03).to(device, dtype)
    return x, k


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    if device.type == "cpu":
        x, k = inputs((8, 8, 16, 16), 16, device, torch.float32)
        out = conv3d_cl(x, k)
        print(f"plain at x {tuple(x.shape)}: out {tuple(out.shape)} max |out| "
              f"{out.abs().max().item():.3f}")
        return
    x, k = inputs(SHAPE, N_OUT, device)
    kw = library_weight(k)
    flops, nbytes = conv_costs(x, k)
    ms = common.cuda_ms(lambda: conv3d_cl(x, k))
    lib_ms = common.cuda_ms(lambda: library_conv(x[None], kw))
    print(common.rate_line(f"halo tile, x {SHAPE} bf16 -> O={N_OUT}", ms, flops, nbytes,
                           lib_ms), flush=True)


if __name__ == "__main__":
    main()
