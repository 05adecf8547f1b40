"""Fisheye ROI warping as separable batched matmuls, and resizes.

Port of ``lintransunet_tpu/ops/resample.py`` on ``(N, C, H, W, D)``. The
reference warps with ``F.grid_sample`` over a piecewise-linear fisheye
grid (Unet_3Dblock.py:51-82, 985-1117) whose x-coordinate depends only on
the output row and y only on the output column, so a bilinear warp is two
matmuls with tent-weight matrices. Out-of-range samples get zero weight,
as grid_sample's zero padding does.
"""

import torch
import torch.nn.functional as F


def _column(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).reshape(-1, 1)


def transfer_index_pix(x0, x1, h, roi_size: int,
                       eval_roi_size: int) -> torch.Tensor:
    """Forward fisheye grid in pixel units: (B,) box extents -> (B,
    eval_roi_size) full-image coordinates (``get_transfer_index``). ``h``
    is the real distance, H - 1."""
    x0, x1 = _column(x0), _column(x1)
    idx = torch.arange(eval_roi_size, dtype=torch.float32, device=x0.device)[None]
    k2 = (x1 - x0) / (roi_size - 1)
    k1 = (h - x1 + x0) / (eval_roi_size - roi_size)
    out = idx * k2 + x0 * (1 - k2 / k1)
    low = out * (k1 / k2) + x0 * (1 - k1 / k2)
    out = torch.where(out <= x0, low, out)
    high = out * (k1 / k2) + x1 * (1 - k1 / k2)
    return torch.where(out >= x1, high, out)


def transfer_back_index_pix(x0, x1, h, roi_size: int,
                            eval_roi_size: int) -> torch.Tensor:
    """Inverse fisheye grid: (B,) box extents -> (B, h + 1) coordinates in
    ROI pixels over the eval_roi_size scale (``get_transfer_back_index``)."""
    x0, x1 = _column(x0), _column(x1)
    idx = torch.arange(int(h) + 1, dtype=torch.float32, device=x0.device)[None]
    k2 = roi_size / (x1 - x0)
    k1 = (eval_roi_size - roi_size) / (h - x1 + x0)
    p0 = x0 * k1
    p1 = eval_roi_size - (h - x1) * k1
    out = idx * k2 + p0 * (1 - k2 / k1)
    low = out * (k1 / k2) + p0 * (1 - k1 / k2)
    out = torch.where(out <= p0, low, out)
    high = out * (k1 / k2) + p1 * (1 - k1 / k2)
    return torch.where(out >= p1, high, out)


def transfer_index(x0, x1, h, roi_size: int, eval_roi_size: int) -> torch.Tensor:
    """The forward fisheye grid normalised to [-1, 1] (align_corners), as
    ``F.grid_sample`` takes it (``get_transfer_index``,
    Unet_3Dblock.py:51-64); ``h`` is H - 1."""
    return transfer_index_pix(x0, x1, h, roi_size, eval_roi_size) * 2.0 / h - 1.0


def transfer_back_index(x0, x1, h, roi_size: int, eval_roi_size: int) -> torch.Tensor:
    """The inverse fisheye grid normalised over the eval_roi_size axis, (B,
    h + 1) (``get_transfer_back_index``, Unet_3Dblock.py:66-82)."""
    return (transfer_back_index_pix(x0, x1, h, roi_size, eval_roi_size)
            * 2.0 / eval_roi_size - 1.0)


def solid_transfer_index(x0, x1, h, eval_roi_size: int) -> torch.Tensor:
    """Identity-slope fisheye grid (``get_solid_transfer_index``,
    Unet_3Dblock.py:84-102; on no live path): slope 1 inside the box, a
    linear squeeze outside; normalised to [-1, 1]."""
    x0, x1 = _column(x0), _column(x1)
    idx = torch.arange(eval_roi_size, dtype=torch.float32, device=x0.device)[None]
    k1 = (h - x1 + x0) / (eval_roi_size - 1 - x1 + x0)
    out = idx + x0 * (1 - 1 / k1)
    out = torch.where(out <= x0, idx * k1, out)
    out = torch.where(out >= x1, (idx - eval_roi_size + 1) * k1 + h, out)
    return out * 2.0 / h - 1.0


def solid_back_index(x0, x1, h, eval_roi_size: int) -> torch.Tensor:
    """Inverse of ``solid_transfer_index`` (``get_solid_back_index``,
    Unet_3Dblock.py:104-120; on no live path), (B, h + 1), normalised."""
    x0, x1 = _column(x0), _column(x1)
    idx = torch.arange(int(h) + 1, dtype=torch.float32, device=x0.device)[None]
    k1 = (eval_roi_size - 1 - x1 + x0) / (h - x1 + x0)
    p0 = x0 * k1
    p1 = eval_roi_size - 1 - (h - x1) * k1
    out = idx + p0 * (1 - k1)
    out = torch.where(out <= p0, out * k1 + p0 * (1 - k1), out)
    out = torch.where(out >= p1, out * k1 + p1 * (1 - k1), out)
    return out * 2.0 / (eval_roi_size - 1) - 1.0


def bilinear_weights_pix(pix: torch.Tensor, in_size: int) -> torch.Tensor:
    """(B, M) pixel coordinates -> (B, M, in_size) tent weights; rows of
    out-of-range samples are zero."""
    grid = torch.arange(in_size, dtype=torch.float32, device=pix.device)
    return (1.0 - (pix[..., None] - grid).abs()).clamp_min(0.0)


def bilinear_weights(coords: torch.Tensor, in_size: int) -> torch.Tensor:
    """(B, M) normalised align_corners coordinates -> (B, M, in_size) tent
    weights."""
    return bilinear_weights_pix((coords.float() + 1.0) * 0.5 * (in_size - 1), in_size)


def separable_grid_sample_2d(x: torch.Tensor, wx: torch.Tensor,
                             wy: torch.Tensor) -> torch.Tensor:
    """Warp (N, C, H, W, D) by per-sample separable weights wx (N, OH, H)
    and wy (N, OW, W): two batched matmuls, contracting H then W, in ``x``'s
    dtype. Equals a bilinear grid_sample applied slice by slice over D."""
    t = torch.einsum("nih,nchwd->nciwd", wx.to(x.dtype), x)
    return torch.einsum("njw,nciwd->ncijd", wy.to(x.dtype), t)


def _triple(scale):
    return (scale,) * 3 if isinstance(scale, (int, float)) else tuple(scale)


def resize_linear_align_corners(x: torch.Tensor, scale) -> torch.Tensor:
    """Trilinear upsample, align_corners=True, of (N, C, H, W, D)
    (``nn.Upsample(mode='trilinear', align_corners=True)``)."""
    size = tuple(int(round(s * v)) for s, v in zip(_triple(scale), x.shape[2:]))
    if size == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=size, mode="trilinear", align_corners=True)


def resize_nearest(x: torch.Tensor, scale) -> torch.Tensor:
    """Nearest upsample by integer factors (``nn.Upsample(scale_factor=s)``):
    out[i] = in[i // s] on each spatial axis."""
    for dim, s in zip((2, 3, 4), _triple(scale)):
        if int(s) != 1:
            x = x.repeat_interleave(int(s), dim=dim)
    return x
