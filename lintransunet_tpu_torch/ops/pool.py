"""Pooling on the port's channels-first tensors (port of
``lintransunet_tpu/ops/pool.py``, which pools channels-last with XLA's
reduce_window). No Pallas kernel is involved: PyTorch's own pooling does
the work.

Used for the deep-supervision label pyramid (utils_3D_embed_full.py:64,
74-76) and PyramidLoss downsampling (loss/criterions.py:545-546).
"""

from typing import Sequence, Union

import torch
import torch.nn.functional as F

_IntOr3 = Union[int, Sequence[int]]


def max_pool3d(x: torch.Tensor, kernel_size: _IntOr3,
               stride: _IntOr3 = None) -> torch.Tensor:
    """Max pool over the spatial dims of (N, C, H, W, D). No padding (torch
    default); the stride defaults to the kernel size."""
    return F.max_pool3d(x, kernel_size, stride)


def avg_pool2d(x: torch.Tensor, kernel_size: int, stride: int,
               padding: int) -> torch.Tensor:
    """Average pool over the spatial dims of (N, C, H, W), padding counted
    in the mean (``nn.AvgPool2d``'s default, as PyramidLoss uses it)."""
    return F.avg_pool2d(x, kernel_size, stride, padding, count_include_pad=True)
