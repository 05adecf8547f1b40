"""A channels-last 3x3x3 conv from one staged halo tile: the H100
counterpart of ``experiments/pallas_conv_prototype.py`` (``pallas_conv`` ->
``kernel``, pallas_call at :90).

``conv3d_cl(x, k)`` is the stride-1, padding-1 convolution of x (H, W, D, C)
with k (3, 3, 3, C, O) (HWDIO), no bias, as the probe's reference
``jax.lax.conv_general_dilated(..., ('NHWDC', 'HWDIO', 'NHWDC'))`` (:117).
Design (``csrc/probe_conv.cu``): a persistent block per SM walks output
tiles of 4 x 4 x 32 positions and 64 channels; per chunk of 32 input
channels it stages the tile's halo once, asynchronously, while the previous
chunk's products run, and reads the 27 taps as shifted rows of it; the
weights, packed once per call (``pack_weights``), stream through a ring of
bulk copies. The TPU prototype's depth-parity fold (D pairs folded into 2C
lanes to fill 128 lanes, at twice the FLOPs) is not carried over.

bf16 operands sum in f32 and store bf16; f32 runs FMA in f32. CPU tensors
take ``conv3d_cl_reference``; CUDA tensors launch the kernel or raise.

``python -m lintransunet_tpu_torch.experiments.conv_prototype`` runs the
probe's shape (C = 64, 128 x 128 x 64) on the card, beside ``F.conv3d``.
"""

import functools

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


# The bf16 kernel's weight layout: output groups of NT, input chunks of KC
# channels (64-byte rows)
NT, KC = 64, 32
PIECES = KC // 8                 # 16-byte pieces in a row of one output's KC channels


def _packed_layout(c, o):
    """For each element of the packed weights (see ``pack_weights``), its
    flat index in k (3, 3, 3, C, O). Row n's stored 16-byte piece p holds
    logical piece p ^ ((n >> 1) & 3): the 64-byte swizzle of ``ltu::swz``
    and of the tensor cores' descriptors."""
    t = torch.arange(27 * c * o).reshape(3, 3, 3, c // KC, PIECES, 8, o // NT, NT)
    t = t.permute(6, 3, 0, 2, 1, 7, 4, 5)         # og, ch, kh, kd, kw, n, piece, 8
    n = torch.arange(NT)[:, None]
    order = torch.arange(PIECES)[None, :] ^ ((n >> 1) & (PIECES - 1))
    return t[..., n, order, :].reshape(o // NT, c // KC, 3, 3, 3, NT, KC)


@functools.lru_cache(maxsize=None)
def _pack_index(c, o, device):
    """``_packed_layout`` flattened, on ``device``, made once: packing a
    call's weights is then one gather."""
    return _packed_layout(c, o).reshape(-1).to(device)


def pack_weights(k):
    """k (3, 3, 3, C, O) -> the bf16 kernel's weights: bf16 (O / 64, C / 32,
    3 (kh), 3 (kd), 3 (kw), 64 outputs, 32 channels), each output's 32
    channels one swizzled 64-byte row (K-major), so that each (chunk, kh,
    kd) is one contiguous 12 KB copy of its three kw taps."""
    c, o = k.shape[3], k.shape[4]
    flat = k.to(torch.bfloat16).reshape(-1).index_select(0, _pack_index(c, o, k.device))
    return flat.view(o // NT, c // KC, 3, 3, 3, NT, KC)


def check_inputs(x, k, bias):
    """Raise ``ValueError`` or ``TypeError`` on what ``probe_conv.cu`` does
    not take (x (N, H, W, D, C), k (3, 3, 3, C, O), bias (O,) f32 or None);
    return whether the call is bf16."""
    if x.dim() != 5 or k.dim() != 5 or tuple(k.shape[:4]) != (3, 3, 3, x.shape[4]):
        raise ValueError(f"x must be (N, H, W, D, C) and k (3, 3, 3, C, O); got "
                         f"{tuple(x.shape)}, {tuple(k.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32) or k.dtype != x.dtype:
        raise TypeError(f"the kernel takes bf16 or f32 x and k of one dtype; got "
                        f"{x.dtype}, {k.dtype}")
    if not (x.is_contiguous() and k.is_contiguous()):
        raise ValueError("the kernel takes contiguous x and k")
    _, _, w, d, c = x.shape
    o = k.shape[4]
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (o,)
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous f32 ({o},) tensor")
    is_bf16 = x.dtype == torch.bfloat16
    if x.numel() == 0 or o % NT or c % (KC if is_bf16 else 16):
        raise ValueError(f"x {tuple(x.shape)} -> O={o}: the kernel takes O % {NT} == 0 and "
                         f"C % {KC if is_bf16 else 16} == 0")
    if not is_bf16 and (d % 16 or 128 % d or w % (128 // d)):
        raise ValueError(f"x {tuple(x.shape)}: the f32 kernel takes D in 16, 32, 64 or 128 "
                         f"and W a multiple of 128 / D")
    return is_bf16


def run_conv(x, k, bias):
    """Check CUDA inputs and launch ``probe_conv.cu`` once (uncounted). bf16
    packs the weights first, inside the call."""
    from lintransunet_tpu_torch import kernels

    is_bf16 = check_inputs(x, k, bias)
    tensors = [x, k] + ([] if bias is None else [bias])
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("every input must be on one CUDA device")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    n, h, w, d, c = x.shape
    o = k.shape[4]
    lib = kernels.load("probe_conv")
    weights = pack_weights(k) if is_bf16 else k
    out = torch.empty((n, h, w, d, o), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pc_forward(x.data_ptr(), weights.data_ptr(),
                             None if bias is None else bias.data_ptr(), out.data_ptr(),
                             n, h, w, d, c, o, int(is_bf16), stream)
    if err != 0:
        raise RuntimeError(f"probe_conv kernel launch failed: CUDA error {err}")
    return out


def conv3d_cl(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """3x3x3 conv, stride 1, padding 1, of x (H, W, D, C) with k (3, 3, 3,
    C, O): (H, W, D, O) in x's dtype (bf16 or f32). ``conv3d_cl.launches``
    counts launches."""
    if x.device.type == "cpu":
        return conv3d_cl_reference(x, k)
    if x.dim() != 4:
        raise ValueError(f"x must be (H, W, D, C); got {tuple(x.shape)}")
    out = run_conv(x[None], k, None)[0]
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
    pack_ms = common.cuda_ms(lambda: pack_weights(k))
    print(f"pack_weights alone (inside every bf16 call): {pack_ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
