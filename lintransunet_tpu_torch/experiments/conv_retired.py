"""A channels-last 3x3x3 conv from row-flattened tiles with depth-shifted
copies: the H100 counterpart of ``experiments/pallas_conv_retired.py``
(``packed_conv3d_stride1_pallas`` -> ``_kernel``, pallas_call at :149).

``conv3d_cl_rows(xp, k, bias, th, tw)`` is the stride-1, padding-1 conv of
xp (N, H2, W2, D, C4) with k (3, 3, 3, C4, O4) plus bias (O4,), as
``lintransunet_tpu/ops/packed_conv.py`` ``packed_conv3d_stride1`` (:267)
computes it. Design (``csrc/probe_conv.cu``, ``rows``): the block's
(th + 2) x (tw + 2) x D tile is flattened to rows, each (dh, dw) tap is a
row offset that is a multiple of D, and three depth-shifted copies are
staged so that no tap reads at an offset of one row. The TPU kernel's
8 x 8 tiles do not fit a block's shared memory: here th * tw * D = 128
(default th = 1, tw = 128 / D). Its W-halo outputs, computed and dropped
on the TPU, are not computed.

bf16 operands sum in f32 and store bf16 (the bias is rounded to the
input's dtype first, as the TPU kernel does); f32 runs FMA in f32. CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.

``python -m lintransunet_tpu_torch.experiments.conv_retired`` runs the
flagship's level-0 packed shape (C4 = O4 = 64) and the 8C-lane shape
(C4 = O4 = 128) on the card, beside ``F.conv3d`` and the halo design.
"""

from typing import Optional

import torch

from lintransunet_tpu_torch.experiments import common
from lintransunet_tpu_torch.experiments.conv_prototype import (
    conv3d_cl_reference,
    conv_costs,
    default_tile,
    library_conv,
    library_weight,
    run_conv,
)

# (label, xp shape, O4): the flagship's level-0 packed conv, and the
# "8C-lane" shape the TPU kernel's docstring names
SHAPES = [("level-0 packed", (1, 128, 128, 64, 64), 64),
          ("8C-lane", (1, 128, 128, 64, 128), 128)]


def _bias(bias, dtype):
    return None if bias is None else bias.to(dtype).float()


def conv3d_cl_rows_reference(xp, k, bias=None):
    return conv3d_cl_reference(xp, k, _bias(bias, xp.dtype))


def conv3d_cl_rows(xp: torch.Tensor, k: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   th: Optional[int] = None, tw: Optional[int] = None) -> torch.Tensor:
    """xp (N, H2, W2, D, C4) conv k (3, 3, 3, C4, O4) + bias (O4,): (N, H2,
    W2, D, O4) in xp's dtype (bf16 or f32). ``conv3d_cl_rows.launches``
    counts launches."""
    if xp.device.type == "cpu":
        return conv3d_cl_rows_reference(xp, k, bias)
    if th is None or tw is None:
        th, tw = default_tile(xp.shape[3])
    out = run_conv(xp, k, _bias(bias, xp.dtype), th, tw, rows=True)
    conv3d_cl_rows.launches += 1
    return out


conv3d_cl_rows.launches = 0


def inputs(shape, n_out, device, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    xp = torch.randn(shape, generator=g).to(device, dtype)
    k = (torch.randn((3, 3, 3, shape[-1], n_out), generator=g) * 0.03).to(device, dtype)
    bias = (torch.randn((n_out,), generator=g) * 0.1).to(device)
    return xp, k, bias


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    if device.type == "cpu":
        xp, k, bias = inputs((1, 8, 8, 16, 16), 16, device, torch.float32)
        out = conv3d_cl_rows(xp, k, bias)
        print(f"plain at xp {tuple(xp.shape)}: out {tuple(out.shape)} max |out| "
              f"{out.abs().max().item():.3f}")
        return
    for label, shape, n_out in SHAPES:
        xp, k, bias = inputs(shape, n_out, device)
        kw = library_weight(k)
        b16 = bias.bfloat16()
        flops, nbytes = conv_costs(xp, k)
        th, tw = default_tile(shape[3])
        rows_ms = common.cuda_ms(lambda: conv3d_cl_rows(xp, k, bias))
        halo_ms = common.cuda_ms(lambda: run_conv(xp, k, bias, th, tw, rows=False))
        lib_ms = common.cuda_ms(lambda: library_conv(xp, kw, b16))
        print(common.rate_line(f"rows, {label} {shape} bf16 -> O4={n_out}", rows_ms,
                               flops, nbytes, lib_ms), flush=True)
        print(common.rate_line(f"halo, {label} {shape} bf16 -> O4={n_out}", halo_ms,
                               flops, nbytes, lib_ms), flush=True)


if __name__ == "__main__":
    main()
