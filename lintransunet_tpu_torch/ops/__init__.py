"""Primitive layer: plain PyTorch functions on ``(N, C, H, W, D)`` tensors.

Attention lives in two submodules, imported by name: ``ops.attention``
(the plain ops, with the optional mask) and ``ops.linear_attention`` (the
fused op whose CUDA kernel is in ``csrc/``, with its plain version). The
fused eval configuration's ops are submodules too: ``ops.conv_unit`` (the
stride-1 conv unit) and ``ops.fused_stack`` (the transformer stack), each a
CUDA kernel in ``csrc/`` with its plain version.
"""

from lintransunet_tpu_torch.ops.bbox import mask_boundary, min_max_indice, min_max_indice2
from lintransunet_tpu_torch.ops.conv import conv3d, instance_norm, leaky_relu
from lintransunet_tpu_torch.ops.patchify import windows_embedding, windows_unembedding
from lintransunet_tpu_torch.ops.resample import (
    bilinear_weights_pix,
    resize_linear_align_corners,
    resize_nearest,
    separable_grid_sample_2d,
    transfer_back_index_pix,
    transfer_index_pix,
)

__all__ = [
    "mask_boundary",
    "min_max_indice",
    "min_max_indice2",
    "conv3d",
    "instance_norm",
    "leaky_relu",
    "windows_embedding",
    "windows_unembedding",
    "bilinear_weights_pix",
    "resize_linear_align_corners",
    "resize_nearest",
    "separable_grid_sample_2d",
    "transfer_back_index_pix",
    "transfer_index_pix",
]
