"""Sliding-window inference over a full volume, ``(N, C, H, W, D)``.

Port of ``lintransunet_tpu/engine/sliding_window.py``, the replacement for
``monai.inferers.sliding_window_inference`` as the reference calls it
(utils_3D_embed_full.py:148: overlap 0.6, sigma_scale 0, constant
blending). Only real windows are forwarded: a last chunk smaller than
``sw_batch_size`` runs as it is, as in MONAI, with no weight-0 pad windows.

Every grid blends the same way: a canvas accumulates each window's
prediction (times the importance map in gaussian mode) and is divided by the
normalisation map, which is built on the canvas's device. The JAX package's
static depth-region blend computes the same sums in another form for XLA's
static shapes; eager PyTorch needs no second form.
"""

import functools
import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Predictor = Callable[[torch.Tensor], torch.Tensor]


def scan_interval(image_size: Sequence[int], roi_size: Sequence[int],
                  overlap: float) -> Tuple[int, ...]:
    """MONAI _get_scan_interval: 0 when the roi covers the dim, else
    roi * (1 - overlap), at least 1."""
    out = []
    for im, roi in zip(image_size, roi_size):
        out.append(0 if roi == im else max(int(roi * (1 - overlap)), 1))
    return tuple(out)


def window_starts_1d(size: int, roi: int, interval: int) -> list:
    """MONAI dense_patch_slices: the last start is clipped to size - roi."""
    if interval == 0:
        return [0]
    count = int(math.ceil((size - roi) / interval)) + 1
    return [min(i * interval, size - roi) for i in range(count)]


def dense_window_starts(image_size, roi_size, overlap) -> np.ndarray:
    """(num_windows, 3) int array of window origins."""
    intervals = scan_interval(image_size, roi_size, overlap)
    per_dim = [window_starts_1d(s, r, i)
               for s, r, i in zip(image_size, roi_size, intervals)]
    grid = np.meshgrid(*per_dim, indexing="ij")
    return np.stack([g.reshape(-1) for g in grid], axis=-1).astype(np.int32)


def gaussian_importance(roi_size, sigma_scale: float) -> np.ndarray:
    """MONAI GaussianFilter-style importance map (mode='gaussian')."""
    maps = []
    for r in roi_size:
        sigma = max(sigma_scale * r, 1e-3)
        x = np.arange(r, dtype=np.float64)
        maps.append(np.exp(-0.5 * ((x - (r - 1) / 2.0) / sigma) ** 2))
    out = functools.reduce(np.multiply.outer, maps)
    out = np.clip(out, np.max(out) * 1e-3, None)
    return out.astype(np.float32)


def _importance(roi_size, mode: str, sigma_scale: float, device):
    """Per-window blend weight: the gaussian map, or 1 in constant mode."""
    if mode == "gaussian":
        return torch.from_numpy(gaussian_importance(roi_size, sigma_scale)).to(device)
    return 1.0


def normalisation_map(padded_spatial, roi_size, overlap, mode="constant",
                      sigma_scale: float = 0.0, device=None) -> torch.Tensor:
    """Sum of per-window importance at every voxel of the padded volume, as
    an f32 tensor on ``device``."""
    starts = dense_window_starts(padded_spatial, roi_size, overlap)
    imp = _importance(roi_size, mode, sigma_scale, device)
    rh, rw, rd = roi_size
    norm = torch.zeros(tuple(padded_spatial), dtype=torch.float32, device=device)
    for sx, sy, sz in starts:
        norm[sx:sx + rh, sy:sy + rw, sz:sz + rd] += imp
    return norm


def padded_spatial_shape(spatial, roi_size):
    return tuple(max(s, r) for s, r in zip(spatial, roi_size))


def _pad_to_roi(x: torch.Tensor, roi_size) -> Tuple[torch.Tensor, list]:
    """Symmetric zero pad so every spatial dim >= roi (MONAI); returns the
    padded volume and the (before, after) pad of each spatial dim."""
    pads = []
    for s, r in zip(x.shape[2:], roi_size):
        diff = max(r - s, 0)
        pads.append((diff // 2, diff - diff // 2))
    if any(p != (0, 0) for p in pads):
        flat = [v for p in reversed(pads) for v in p]  # F.pad: last dim first
        x = F.pad(x, flat)
    return x, pads


def _crop(out: torch.Tensor, pads, spatial) -> torch.Tensor:
    if all(p == (0, 0) for p in pads):
        return out
    sl = tuple(slice(p[0], p[0] + s) for p, s in zip(pads, spatial))
    return out[(slice(None), slice(None)) + sl]


def _check_args(roi_size, sw_batch_size, mode):
    if len(roi_size) != 3:
        raise ValueError(f"roi_size must have 3 dims, got {roi_size}")
    if sw_batch_size < 1:
        raise ValueError(f"sw_batch_size must be >= 1, got {sw_batch_size}")
    if mode not in ("constant", "gaussian"):
        raise ValueError(f"mode must be 'constant' or 'gaussian', got {mode!r}")


def _window_predictions(x: torch.Tensor, starts: np.ndarray, roi_size,
                        sw_batch_size: int, predictor: Predictor):
    """Yield (start, prediction) per window in grid order; windows run
    through ``predictor`` ``sw_batch_size`` at a time, concatenated on the
    batch dim."""
    n = x.shape[0]
    rh, rw, rd = roi_size
    for c0 in range(0, len(starts), sw_batch_size):
        chunk = starts[c0:c0 + sw_batch_size]
        batch = torch.cat([x[:, :, sx:sx + rh, sy:sy + rw, sz:sz + rd]
                           for sx, sy, sz in chunk], dim=0)
        preds = predictor(batch)
        for i, start in enumerate(chunk):
            yield tuple(int(s) for s in start), preds[i * n:(i + 1) * n]


@torch.inference_mode()
def sliding_window_inference(inputs: torch.Tensor, roi_size: Sequence[int],
                             sw_batch_size: int, predictor: Predictor,
                             overlap: float = 0.6, mode: str = "constant",
                             sigma_scale: float = 0.125) -> torch.Tensor:
    """Blend per-window predictions over a volume with a canvas and the
    normalisation map. inputs: (N, C, H, W, D); predictor: (M, C, h, w, d)
    -> (M, C', h, w, d). Returns f32 (N, C', H, W, D)."""
    roi_size = tuple(int(r) for r in roi_size)
    _check_args(roi_size, sw_batch_size, mode)
    x, pads = _pad_to_roi(inputs, roi_size)
    spatial = tuple(x.shape[2:])
    starts = dense_window_starts(spatial, roi_size, overlap)
    dev = inputs.device
    imp = _importance(roi_size, mode, sigma_scale, dev)
    rh, rw, rd = roi_size
    canvas = None
    for (sx, sy, sz), pred in _window_predictions(x, starts, roi_size,
                                                  sw_batch_size, predictor):
        contrib = pred.float()
        if mode == "gaussian":
            contrib = contrib * imp
        if canvas is None:
            canvas = torch.zeros((x.shape[0], pred.shape[1]) + spatial,
                                 dtype=torch.float32, device=dev)
        canvas[:, :, sx:sx + rh, sy:sy + rw, sz:sz + rd] += contrib
    canvas /= normalisation_map(spatial, roi_size, overlap, mode, sigma_scale, dev)
    return _crop(canvas, pads, inputs.shape[2:])


def _with_background(fg: torch.Tensor) -> torch.Tensor:
    return torch.cat([1.0 - fg, fg], dim=1)


class SlidingWindowRunner:
    """Full-volume inference: ``sliding_window_inference`` with the runner's
    geometry (MONAI's symmetric pad-to-roi, the window grid of the padded
    extent, the crop back to the volume).

    ``derive_background``: the predictor emits only the class-1 channel of
    a 2-class one-hot (``make_eval_forward(fg_only=True)``); the runner
    blends that channel and rebuilds class 0 as 1 - class 1, which is exact
    for any blend weights: sum(w(1-p))/sum(w) == 1 - sum(wp)/sum(w).

    ``device``: where the predictor runs (``make_eval_runner`` passes the
    model's); a volume is moved there and the blend stays there. None
    keeps each volume where it is.
    """

    def __init__(self, predictor: Predictor, roi_size, sw_batch_size: int = 1,
                 overlap: float = 0.6, mode: str = "constant",
                 sigma_scale: float = 0.0, derive_background: bool = False,
                 device=None):
        self.roi_size = tuple(int(r) for r in roi_size)
        _check_args(self.roi_size, sw_batch_size, mode)
        self.predictor = predictor
        self.sw_batch_size = sw_batch_size
        self.overlap = overlap
        self.mode = mode
        self.sigma_scale = sigma_scale
        self.derive_background = derive_background
        self.device = None if device is None else torch.device(device)

    def __call__(self, volume: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W, D) -> f32 (N, C', H, W, D) on the runner's device."""
        if self.device is not None:
            volume = volume.to(self.device)
        out = sliding_window_inference(
            volume, self.roi_size, self.sw_batch_size, self.predictor,
            self.overlap, self.mode, self.sigma_scale)
        return _with_background(out) if self.derive_background else out
