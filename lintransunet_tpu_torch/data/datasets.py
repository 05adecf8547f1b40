"""CT pancreas datasets: .npy volumes -> augmented fixed-shape patch stacks
(the port's own copy of ``lintransunet_tpu/data/datasets.py``).

Mirrors the three dataset families of the reference:

* ``IdPosPanCTDataset`` / ``EvaPanCTDataset`` — binary task, .npy volumes,
  HU window [-91, 250], mean 86.9 / std 39.4 (dataset/CT_pancreas_ids.py).
* ``MultiClassPanCTDataset`` / ``MultiClassEvaDataset`` — multi-class task,
  HU window [-96, 215], mean 77.99 / std 75.4
  (dataset/CT_pancreas_multi_class.py).
* ``CachePanDataset`` / ``EvaPanDataset`` — MONAI-pipeline variant with
  in-RAM caching of deterministic preprocessing
  (dataset/CT_pancreas_monai.py): ScaleIntensityRanged + Spacingd + RAS,
  then per-epoch random crops/flips/rot90.

Volumes on disk are (D, H, W) as in the reference (it transposes to
(H, W, D), CT_pancreas_ids.py:153-154). Outputs are channels-last numpy,
bit for bit the JAX package's (the training loop and ``batched_predictions``
turn them into the model's (N, C, H, W, D) on the way to the device):
images (num_samples, H, W, D, 1), labels (num_samples, H, W, D).
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from lintransunet_tpu_torch.data import transforms as T


class _NpyVolumeDataset:
    """Shared directory listing / id selection (image/ + label/ of .npy)."""

    def __init__(self, root: str, ids: Optional[Sequence[int]] = None):
        self.root = root
        self.full_img_path = sorted(os.listdir(os.path.join(root, "image")))
        self.full_label_path = sorted(os.listdir(os.path.join(root, "label")))
        if ids is None:
            ids = range(len(self.full_img_path))
        self.img_path = [self.full_img_path[i] for i in ids]
        self.label_path = [self.full_label_path[i] for i in ids]

    def __len__(self) -> int:
        return len(self.img_path)

    def _load(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        img = np.load(os.path.join(self.root, "image", self.img_path[index]))
        label = np.load(os.path.join(self.root, "label", self.label_path[index]))
        return img, label


class IdPosPanCTDataset(_NpyVolumeDataset):
    """Binary training dataset (CT_pancreas_ids.py:89-173).

    Per __getitem__: HU window + normalise, transpose (D,H,W)->(H,W,D),
    pos/neg patch sampling (512x512xdepth, pos .7/neg .3, num_samples),
    RandRotated +-20deg, RandAdjustContrast, RandZoomd 0.7-1.3, RandFlipd.
    """

    low_clip, high_clip = -91.0, 250.0
    mean, std = 86.9, 39.4
    binary_labels = True

    def __init__(self, root, depth_size: int, num_samples: int = 12,
                 is_transform: bool = True, ids=None, image_crop: int = 512,
                 seed: int = 0):
        super().__init__(root, ids)
        self.depth_size = depth_size
        self.num_samples = num_samples
        self.is_transform = is_transform
        self.image_crop = image_crop
        self.prob = 0.4
        self._seed = seed

    def __getitem__(self, index: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, index,
                                    np.random.randint(0, 2 ** 31)]))
        img, label = self._load(index)
        img = T.hu_window_normalise(img, self.low_clip, self.high_clip,
                                    self.mean, self.std)
        img = img.transpose(1, 2, 0)
        label = label.transpose(1, 2, 0).astype(np.uint8)

        size = (self.image_crop, self.image_crop, self.depth_size)
        imgs, labels = T.rand_crop_by_pos_neg_label(
            img, label, size, pos=0.7, neg=0.3,
            num_samples=self.num_samples, rng=rng)

        out_i, out_l = [], []
        for i in range(self.num_samples):
            ii, ll = imgs[i], labels[i]
            if self.is_transform:
                # MONAI RandRotated fires with default prob=0.1; the
                # reference passes no prob (CT_pancreas_ids.py:122-127)
                ii, ll = T.rand_rotate(ii, ll, np.pi / 9, rng, prob=0.1)
                ii = T.rand_adjust_contrast(ii, rng, prob=self.prob)
                ii, ll = T.rand_zoom(ii, ll, rng, prob=self.prob,
                                     min_zoom=0.7, max_zoom=1.3)
                ii, ll = T.rand_flip(ii, ll, rng, prob=self.prob,
                                     spatial_axes=(0, 1))
            out_i.append(ii)
            if self.binary_labels:
                out_l.append((ll >= 0.5).astype(np.uint8))
            else:
                out_l.append(np.rint(ll).astype(np.uint8))
        images = np.stack(out_i)[..., None].astype(np.float32)
        return images, np.stack(out_l)


class MultiClassPanCTDataset(IdPosPanCTDataset):
    """Multi-class training dataset (CT_pancreas_multi_class.py:89-180):
    HU window [-96, 215], mean 77.99 / std 75.4; labels stay class ids."""

    low_clip, high_clip = -96.0, 215.0
    mean, std = 77.99, 75.4
    binary_labels = False


class EvaPanCTDataset(_NpyVolumeDataset):
    """Binary eval dataset: full volume, HU window, no augmentation
    (CT_pancreas_ids.py:176-252). Returns (1, H, W, D, 1) and (1, H, W, D)."""

    low_clip, high_clip = -91.0, 250.0
    mean, std = 86.9, 39.4
    binary_labels = True

    def __init__(self, root, depth_size: int, ids=None):
        super().__init__(root, ids)
        self.depth_size = depth_size

    def __getitem__(self, index: int):
        img, label = self._load(index)
        img = T.hu_window_normalise(img, self.low_clip, self.high_clip,
                                    self.mean, self.std)
        if self.binary_labels:
            label = (label > 0.5).astype(np.uint8)
        else:
            label = label.astype(np.uint8)
        # (D, H, W) -> (H, W, D); reference permutes to (C, H, W, D)
        # (CT_pancreas_ids.py:251); channels-last here.
        img = img.transpose(1, 2, 0)[None, ..., None].astype(np.float32)
        label = label.transpose(1, 2, 0)[None]
        return img, label


class MultiClassEvaDataset(EvaPanCTDataset):
    """Multi-class eval dataset (CT_pancreas_multi_class.py:183-255)."""

    low_clip, high_clip = -96.0, 215.0
    mean, std = 77.99, 75.4
    binary_labels = False


class CachePanDataset:
    """MONAI-CacheDataset equivalent (CT_pancreas_monai.py:18-68).

    Deterministic preprocessing — load, ScaleIntensityRanged, Spacingd
    resample to pixdim (0.5, 0.5, 2.0) and Orientationd-to-RAS
    (CT_pancreas_monai.py:41-48, both unconditional in the reference) — is
    computed once across worker threads and cached in RAM; random transforms
    (pos/neg crop, flip axis 0, rot90) run per access.

    Sources are ``.nii``/``.nii.gz`` (first-party reader, spacing/axcodes
    derived from the affine — data/nifti.py) or ``.npy`` volumes, whose
    layout is described by ``source_axcodes``/``source_spacing`` (defaults:
    "SRA" + 1 mm isotropic; "SRA" makes orientation reduce to the historic
    (D, H, W) -> (H, W, D) transpose). The pipeline orients FIRST, then
    resamples with per-axis spacing permuted to RAS — mathematically the
    same volume MONAI's world-space Spacingd -> Orientationd chain produces
    for axis-aligned affines, with pixdim then matching array axes 1:1.
    After RAS orientation the array is already the model's (H, W, D) layout.
    """

    low_clip, high_clip = -96.0, 215.0
    mean, std = 77.99, 75.4
    pixdim = (0.5, 0.5, 2.0)

    def __init__(self, root, depth_size: int, num_samples: int = 1,
                 ids=None, image_crop: int = 512, num_workers: int = 8,
                 source_spacing=(1.0, 1.0, 1.0), source_axcodes: str = "SRA",
                 resample: bool = True, orient: bool = True,
                 seed: int = 0, train: bool = True):
        self.root = root
        self.depth_size = depth_size
        self.num_samples = num_samples
        self.image_crop = image_crop
        self.train = train
        self._seed = seed
        img_dir = "imagesTr" if os.path.isdir(os.path.join(root, "imagesTr")) \
            else "image"
        lbl_dir = "labelsTr" if os.path.isdir(os.path.join(root, "labelsTr")) \
            else "label"
        imgs = sorted(os.listdir(os.path.join(root, img_dir)))
        lbls = sorted(os.listdir(os.path.join(root, lbl_dir)))
        if ids is None:
            ids = range(len(imgs))
        self._files = [(os.path.join(root, img_dir, imgs[i]),
                        os.path.join(root, lbl_dir, lbls[i])) for i in ids]
        self.source_spacing = tuple(float(s) for s in source_spacing)
        self.source_axcodes = source_axcodes
        self.resample = resample
        self.orient = orient

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            self._cache = list(pool.map(self._prepare, range(len(self._files))))

    def _load_volume(self, path: str):
        """-> (array, affine or None). NIfTI via the first-party reader."""
        if path.endswith(".npy"):
            return np.load(path), None
        from lintransunet_tpu_torch.data import nifti

        return nifti.read_nifti(path)

    def _prepare(self, index: int):
        img_path, lbl_path = self._files[index]
        img, affine = self._load_volume(img_path)
        label, _ = self._load_volume(lbl_path)
        img = T.scale_intensity_range(
            img.astype(np.float32), self.low_clip, self.high_clip,
            (self.low_clip - self.mean) / self.std,
            (self.high_clip - self.mean) / self.std, clip=True)

        if affine is not None:
            spacing, axcodes = T.affine_to_spacing_axcodes(affine)
        else:
            spacing, axcodes = self.source_spacing, self.source_axcodes

        order, _ = T.ras_permutation(axcodes)
        if self.orient:
            img = T.orient_ras(img, axcodes)
            label = T.orient_ras(label, axcodes)
            spacing = tuple(spacing[o] for o in order)
            target = self.pixdim
        else:
            # pixdim is RAS-ordered; permute it back onto the source axes
            target = [0.0] * 3
            for t, src in enumerate(order):
                target[src] = self.pixdim[t]
        if self.resample:
            img, label = T.spacing_resample(
                img, spacing, target, order=1, label=label)
        if not self.orient:
            # legacy (D, H, W) .npy layout without reorientation
            img = img.transpose(1, 2, 0)
            label = label.transpose(1, 2, 0)
        return np.ascontiguousarray(img), \
            np.ascontiguousarray(label).astype(np.uint8)

    def __len__(self) -> int:
        return len(self._cache)

    def __getitem__(self, index: int):
        img, label = self._cache[index]
        if not self.train:
            return (img[None, ..., None].astype(np.float32), label[None])
        rng = np.random.default_rng(
            np.random.SeedSequence([self._seed, index,
                                    np.random.randint(0, 2 ** 31)]))
        size = (self.image_crop, self.image_crop, self.depth_size)
        imgs, labels = T.rand_crop_by_pos_neg_label(
            img, label, size, pos=0.7, neg=0.3,
            num_samples=self.num_samples, rng=rng)
        out_i, out_l = [], []
        for i in range(self.num_samples):
            ii, ll = T.rand_flip(imgs[i], labels[i], rng, prob=0.5,
                                 spatial_axes=(0,))
            ii, ll = T.rand_rotate90(ii, ll, rng, prob=0.5)
            out_i.append(ii)
            out_l.append(np.rint(ll).astype(np.uint8))
        return np.stack(out_i)[..., None].astype(np.float32), np.stack(out_l)


class EvaPanDataset(CachePanDataset):
    """Eval variant of the cached pipeline (CT_pancreas_monai.py:71-115)."""

    def __init__(self, *args, **kwargs):
        kwargs["train"] = False
        super().__init__(*args, **kwargs)
