"""Skip-connection bridges: the mask-guided ROI attention mechanism.

Port of ``lintransunet_tpu/models/bridges.py`` (reference:
Unet_3Dblock.py:647-755, 1080-1199). ``ROIBridge`` derives a box from the
predicted mask, fisheye-warps the skip feature into a fixed-size crop, runs
linear attention on it and warps back; boxes are values, so every shape is
static.
"""

import torch
from torch import nn

from lintransunet_tpu_torch import ops
from lintransunet_tpu_torch.models.blocks import (
    Conv3d,
    EmbedAttention3DBlock,
    PosAttention3DBlock,
)
from lintransunet_tpu_torch.utils import profiling


class ConnectBridge(nn.Module):
    """Bottleneck transformer wrapper (Unet_3Dblock.py:647-670)."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.2,
                 n_layers: int = 8):
        super().__init__()
        self.transformer = PosAttention3DBlock(d_model, d_model, nhead,
                                               dropout, n_layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.transformer(x)


class InitialBridge(nn.Module):
    """Identity for non-ROI levels (Unet_3Dblock.py:1180-1199)."""

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        return x


class ROIBridge(nn.Module):
    """Mask-guided fisheye ROI attention (Unet_3Dblock.py:673-755).

    h_roi = roi_size, w_roi = int(0.6 roi_size), eval sizes 1.2x, minimum
    extents eval // 2; depth is never warped. The output replaces the input
    feature (no residual).
    """

    def __init__(self, in_dim: int, d_model: int, nhead: int,
                 dropout: float = 0.2, n_layers: int = 8, roi_size: int = 32,
                 mask_threshold: float = 0.5):
        super().__init__()
        self.mask_threshold = mask_threshold
        self.h_roi_size = roi_size
        self.w_roi_size = int(roi_size * 0.6)
        self.eval_h_roi_size = int(1.2 * roi_size)
        self.eval_w_roi_size = int(self.eval_h_roi_size * 0.6)
        self.transformer = EmbedAttention3DBlock(in_dim, d_model, nhead,
                                                 dropout, n_layers)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (N, C, H, W, D); mask: (N, 1, H, W, D) foreground probability."""
        h, w = x.shape[2], x.shape[3]
        with torch.no_grad():  # the box is a stop-gradient value
            box = ops.mask_boundary(mask[:, 0] >= self.mask_threshold,
                                    self.eval_h_roi_size // 2,
                                    self.eval_w_roi_size // 2)
        x0, y0, x1, y1 = box[:, 0], box[:, 1], box[:, 3], box[:, 4]

        # forward warp (roi_alignment2, Unet_3Dblock.py:985-1039), pixel units
        gx = ops.transfer_index_pix(x0, x1, h - 1, self.h_roi_size,
                                    self.eval_h_roi_size)
        gy = ops.transfer_index_pix(y0, y1, w - 1, self.w_roi_size,
                                    self.eval_w_roi_size)
        roi = ops.separable_grid_sample_2d(
            x, ops.bilinear_weights_pix(gx, h), ops.bilinear_weights_pix(gy, w))

        roi = self.transformer(roi)

        # Inverse warp (post_processing2, Unet_3Dblock.py:1080-1117). The back
        # grid is normalised by the eval size but grid_sample denormalises by
        # the crop's ACTUAL size (eval + 1 rows for odd eval sizes after the
        # embed round trip), hence the (actual - 1) / eval scale.
        rh, rw = roi.shape[2], roi.shape[3]
        bx = ops.transfer_back_index_pix(
            x0, x1, h - 1, self.h_roi_size, self.eval_h_roi_size
        ) * ((rh - 1) / self.eval_h_roi_size)
        by = ops.transfer_back_index_pix(
            y0, y1, w - 1, self.w_roi_size, self.eval_w_roi_size
        ) * ((rw - 1) / self.eval_w_roi_size)
        return ops.separable_grid_sample_2d(
            roi, ops.bilinear_weights_pix(bx, rh), ops.bilinear_weights_pix(by, rw))


class Bridge(nn.Module):
    """Per-skip ROI orchestrator of ``MaskSkipTransUnet``, the JAX package's
    fixed variant of Unet_3Dblock.py:1202-1274 (the reference builds
    ROIBridge without its in_dim and unpacks a tuple it never returns): a
    ConnectBridge on the bottleneck, then per level, coarse to fine, a
    sigmoid 1x1x1 mask conv upsampled x2 on every axis gives the next
    level's ROIBridge its box. Returns (bottleneck, transformed skips fine
    to coarse, mask_list coarse to fine). Each level's bridge and mask conv
    run in the profiler span ``bridge.level<i>``."""

    def __init__(self, num_layers, roi_size: int = 16, nhead_lens: int = 16,
                 dropout: float = 0.2, n_layers: int = 4):
        super().__init__()
        layers = list(num_layers)
        n = len(layers)
        self.n_levels = n
        roi_sizes = [roi_size * (i + 3) for i in range(n - 1)]
        self.add_module(f"bridge_list_{n - 1}", ConnectBridge(
            layers[-1], layers[-1] // nhead_lens, dropout, n_layers))
        self.add_module(f"mask_conv_list_{n - 1}", Conv3d(layers[-1], 1, 1))
        for i in range(1, n):
            level = n - 1 - i
            self.add_module(f"bridge_list_{level}", ROIBridge(
                layers[level], layers[level], max(1, layers[level] // nhead_lens),
                dropout, n_layers, roi_sizes[-i]))
            if i != n - 1:
                self.add_module(f"mask_conv_list_{level}", Conv3d(layers[level], 1, 1))
        self._spans = [f"bridge.level{level}" for level in range(n)]

    def _mask(self, level: int, x: torch.Tensor) -> torch.Tensor:
        mask = torch.sigmoid(getattr(self, f"mask_conv_list_{level}")(x))
        return ops.resize_linear_align_corners(mask, 2)

    def forward(self, x: torch.Tensor, skips):
        n = self.n_levels
        with profiling.span(self._spans[n - 1]):
            x = getattr(self, f"bridge_list_{n - 1}")(x)
            mask = self._mask(n - 1, x)
        mask_list, trans_list = [mask], []
        for i in range(1, n):
            level = n - 1 - i
            with profiling.span(self._spans[level]):
                out = getattr(self, f"bridge_list_{level}")(skips[-i], mask)
                trans_list.append(out)
                if i != n - 1:
                    mask = self._mask(level, out)
                    mask_list.append(mask)
        return x, trans_list[::-1], mask_list
