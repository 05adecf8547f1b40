"""Host-side volumetric transforms (MONAI-equivalent, numpy/scipy; the
port's own copy of ``lintransunet_tpu/data/transforms.py``).

Re-implements the exact transform chain the reference composes from MONAI
(dataset/CT_pancreas_ids.py:112-135, dataset/CT_pancreas_monai.py:37-57):
HU windowing/normalisation, RandCropByPosNegLabeld positive/negative patch
sampling, random rotation/zoom/contrast/flip/rot90, Spacingd resampling and
RAS orientation. These run on CPU worker threads (augmentation is
bandwidth-light and irregular — the wrong shape for the GPU), feeding
statically-shaped batches to the device.

Arrays are (H, W, D) single-channel volumes unless noted. Each transform is
a pure function taking an explicit np.random.Generator — no global RNG.
"""

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage


def hu_window_normalise(img: np.ndarray, low: float, high: float,
                        mean: float, std: float) -> np.ndarray:
    """Clip to the HU window then standardise (CT_pancreas_ids.py:150-152).

    Runs the native C++ core (``lintransunet_tpu_torch.native``), or its
    numpy fallback where no compiler built it; both give the same bits."""
    from lintransunet_tpu_torch import native

    return native.hu_window_normalize(img, low, high, mean, std)


def scale_intensity_range(img: np.ndarray, a_min: float, a_max: float,
                          b_min: float, b_max: float,
                          clip: bool = True) -> np.ndarray:
    """MONAI ScaleIntensityRanged (CT_pancreas_monai.py:41-46)."""
    img = (img - a_min) / (a_max - a_min)
    img = img * (b_max - b_min) + b_min
    if clip:
        img = np.clip(img, min(b_min, b_max), max(b_min, b_max))
    return img.astype(np.float32)


def rand_crop_by_pos_neg_label(
    img: np.ndarray,
    label: np.ndarray,
    spatial_size: Sequence[int],
    pos: float,
    neg: float,
    num_samples: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """MONAI RandCropByPosNegLabeld semantics (CT_pancreas_ids.py:114-121).

    Each sample's centre is drawn from foreground voxels with probability
    pos/(pos+neg), else from background; centres are clamped so the fixed
    crop fits (crops are padded if the volume is smaller than the patch).
    Returns stacked crops (num_samples, *spatial_size) for image and label.
    """
    spatial_size = tuple(int(s) for s in spatial_size)
    vol_shape = img.shape

    pad = [(max(0, (s - v + 1) // 2), max(0, s - v - max(0, (s - v + 1) // 2)))
           for s, v in zip(spatial_size, vol_shape)]
    if any(p != (0, 0) for p in pad):
        img = np.pad(img, pad)
        label = np.pad(label, pad)
        vol_shape = img.shape

    fg = np.argwhere(label > 0)
    bg = np.argwhere(label == 0)
    p_pos = pos / (pos + neg)

    imgs, labels = [], []
    for _ in range(num_samples):
        use_fg = (rng.random() < p_pos) and len(fg) > 0
        pool = fg if use_fg else (bg if len(bg) > 0 else fg)
        centre = pool[rng.integers(len(pool))]
        start = [
            int(np.clip(c - s // 2, 0, v - s))
            for c, s, v in zip(centre, spatial_size, vol_shape)
        ]
        sl = tuple(slice(st, st + s) for st, s in zip(start, spatial_size))
        imgs.append(img[sl])
        labels.append(label[sl])
    return np.stack(imgs), np.stack(labels)


def rand_rotate(img: np.ndarray, label: np.ndarray, range_rad: float,
                rng: np.random.Generator, prob: float = 0.1
                ) -> Tuple[np.ndarray, np.ndarray]:
    """MONAI RandRotated over all three axes, bilinear image / bilinear label
    (CT_pancreas_ids.py:122-127; the reference rotates labels bilinearly too,
    then re-thresholds downstream)."""
    if rng.random() >= prob:
        return img, label
    angles = rng.uniform(-range_rad, range_rad, size=3)
    axes_pairs = [(0, 1), (0, 2), (1, 2)]
    for angle, axes in zip(angles, axes_pairs):
        deg = math.degrees(angle)
        img = ndimage.rotate(img, deg, axes=axes, reshape=False, order=1,
                             mode="constant", cval=float(img.min()))
        label = ndimage.rotate(label.astype(np.float32), deg, axes=axes,
                               reshape=False, order=1, mode="constant")
    return img, label


def rand_adjust_contrast(img: np.ndarray, rng: np.random.Generator,
                         prob: float = 0.1,
                         gamma: Tuple[float, float] = (0.5, 4.5)) -> np.ndarray:
    """MONAI RandAdjustContrastd: x -> ((x-min)/range)^gamma * range + min."""
    if rng.random() >= prob:
        return img
    g = rng.uniform(*gamma)
    lo, hi = float(img.min()), float(img.max())
    span = max(hi - lo, 1e-7)
    return (((img - lo) / span) ** g * span + lo).astype(np.float32)


def rand_zoom(img: np.ndarray, label: np.ndarray, rng: np.random.Generator,
              prob: float = 0.1, min_zoom: float = 0.9, max_zoom: float = 1.1
              ) -> Tuple[np.ndarray, np.ndarray]:
    """MONAI RandZoomd (trilinear, keep original shape via pad/crop)."""
    if rng.random() >= prob:
        return img, label
    z = rng.uniform(min_zoom, max_zoom)
    out_i = ndimage.zoom(img, z, order=1)
    out_l = ndimage.zoom(label.astype(np.float32), z, order=1)

    def fit(a, ref_shape, cval=0.0):
        slices, pads = [], []
        for have, want in zip(a.shape, ref_shape):
            if have >= want:
                start = (have - want) // 2
                slices.append(slice(start, start + want))
                pads.append((0, 0))
            else:
                slices.append(slice(None))
                diff = want - have
                pads.append((diff // 2, diff - diff // 2))
        a = a[tuple(slices)]
        if any(p != (0, 0) for p in pads):
            a = np.pad(a, pads, constant_values=cval)
        return a

    return fit(out_i, img.shape, float(img.min())), fit(out_l, label.shape)


def rand_flip(img: np.ndarray, label: np.ndarray, rng: np.random.Generator,
              prob: float = 0.1, spatial_axes: Sequence[int] = (0, 1)
              ) -> Tuple[np.ndarray, np.ndarray]:
    """MONAI RandFlipd over the given axes (one coin for the whole flip)."""
    if rng.random() >= prob:
        return img, label
    for ax in spatial_axes:
        img = np.flip(img, axis=ax)
        label = np.flip(label, axis=ax)
    return np.ascontiguousarray(img), np.ascontiguousarray(label)


def rand_rotate90(img: np.ndarray, label: np.ndarray, rng: np.random.Generator,
                  prob: float = 0.5, spatial_axes: Tuple[int, int] = (0, 1)
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """MONAI RandRotate90d (CT_pancreas_monai.py:55)."""
    if rng.random() >= prob:
        return img, label
    k = int(rng.integers(1, 4))
    return (np.ascontiguousarray(np.rot90(img, k, spatial_axes)),
            np.ascontiguousarray(np.rot90(label, k, spatial_axes)))


def spacing_resample(img: np.ndarray, current: Sequence[float],
                     target: Sequence[float], order: int = 1,
                     label: Optional[np.ndarray] = None):
    """MONAI Spacingd: resample to target voxel spacing
    (CT_pancreas_monai.py:47, pixdim (0.5, 0.5, 2.0), bilinear/nearest)."""
    zoom = tuple(c / t for c, t in zip(current, target))
    out_img = ndimage.zoom(img, zoom, order=order)
    if label is None:
        return out_img
    out_lbl = ndimage.zoom(label, zoom, order=0)
    return out_img, out_lbl


def affine_to_spacing_axcodes(affine: np.ndarray):
    """(4x4 voxel->world-RAS affine) -> (per-axis spacing, axcodes).

    spacing[j] is the world-mm step of array axis j (column norm); axcodes[j]
    is the anatomical direction that axis points toward (R/L, A/P, S/I) —
    the same convention as nibabel ``aff2axcodes``. Only needs the affine to
    be axis-dominant (each array axis mostly along one world axis), which
    holds for every scanner-exported CT this pipeline targets.
    """
    rot = np.asarray(affine, np.float64)[:3, :3]
    spacing = np.linalg.norm(rot, axis=0)
    labels = (("L", "R"), ("P", "A"), ("I", "S"))
    codes = []
    for j in range(3):
        col = rot[:, j] / max(spacing[j], 1e-12)
        i = int(np.argmax(np.abs(col)))
        codes.append(labels[i][1] if col[i] > 0 else labels[i][0])
    return tuple(float(s) for s in spacing), "".join(codes)


_FLIP_FOR_RAS = {"L": 0, "P": 1, "I": 2}


def ras_permutation(axcodes: str):
    """(order, flips) taking axes labelled ``axcodes`` onto (R, A, S).

    ``order[t]`` is the source axis that lands on target axis t; ``flips[t]``
    is True when that source axis points the negative way (L/P/I)."""
    order = []
    flips = []
    have = [c.upper() for c in axcodes]
    pos_of = {"R": 0, "L": 0, "A": 1, "P": 1, "S": 2, "I": 2}
    for target_axis in range(3):
        src = next(i for i, c in enumerate(have) if pos_of[c] == target_axis)
        order.append(src)
        flips.append(have[src] in ("L", "P", "I"))
    return order, flips


def orient_ras(volume: np.ndarray, axcodes: str) -> np.ndarray:
    """MONAI Orientationd to RAS given the current axis codes
    (CT_pancreas_monai.py:48). Axes already (R/A/S or L/P/I)-aligned only."""
    assert len(axcodes) == volume.ndim
    order, flips = ras_permutation(axcodes)
    out = np.transpose(volume, order)
    for axis, f in enumerate(flips):
        if f:
            out = np.flip(out, axis=axis)
    return np.ascontiguousarray(out)
