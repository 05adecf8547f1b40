"""Host-side post-processing: KeepLargestConnectedComponent (the port's own
copy of ``lintransunet_tpu/cli/postprocess.py``).

Equivalent of monai.transforms.KeepLargestConnectedComponent as used by
inference_multi_classes.py:104,148-151 (applied_labels=[1, 2],
independent=False, connectivity=3). Runs on host (scipy.ndimage) — it is
outside the hot loop and inherently sequential. ``largest_component_volume``
is the multi-class inference CLI's whole post-processing of one volume.
"""

from typing import Sequence

import numpy as np
import torch
from scipy import ndimage

from lintransunet_tpu_torch.engine.loop import labels_to_device
from lintransunet_tpu_torch.losses.functional import one_hot_map


def keep_largest_connected_component(
    onehot: np.ndarray,
    applied_labels: Sequence[int] = (1, 2),
    independent: bool = False,
    connectivity: int = 3,
) -> np.ndarray:
    """onehot: (C, H, W, D) {0,1}; returns same with non-largest CCs zeroed.

    independent=False: the union of applied labels forms one foreground whose
    largest component is kept; each applied channel is masked by it
    (MONAI semantics for the reference call).
    """
    onehot = np.asarray(onehot)
    structure = ndimage.generate_binary_structure(3, connectivity)
    if independent:
        out = onehot.copy()
        for ch in applied_labels:
            mask = _largest_component(onehot[ch] > 0.5, structure)
            out[ch] = onehot[ch] * mask
        return out
    union = np.zeros(onehot.shape[1:], bool)
    for ch in applied_labels:
        union |= onehot[ch] > 0.5
    mask = _largest_component(union, structure)
    out = onehot.copy()
    for ch in applied_labels:
        out[ch] = onehot[ch] * mask
    return out


def _largest_component(binary: np.ndarray, structure) -> np.ndarray:
    labelled, n = ndimage.label(binary, structure=structure)
    if n == 0:
        return np.zeros_like(binary)
    sizes = ndimage.sum(binary, labelled, index=range(1, n + 1))
    return labelled == (int(np.argmax(sizes)) + 1)


def largest_component_volume(predict, masks, num_classes: int):
    """``inference_multi_classes``'s volume (inference_multi_classes.py:
    131-163): (prediction, target) the criterions take, and the export. The
    blend (1, C, H, W, D) rounded, its class-1 + class-2 union cut to its
    largest 26-connected component, class 0 rebuilt as 1 - p1 - p2, back on
    the blend's device; the one-hot labels; the argmax as a (D, H, W) uint8
    volume."""
    hard = np.rint(predict[0].cpu().numpy())  # (C, H, W, D)
    hard = keep_largest_connected_component(
        hard, applied_labels=(1, 2), independent=False, connectivity=3)
    hard[0] = 1.0 - hard[1] - hard[2]
    target = one_hot_map(labels_to_device(masks, predict.device), num_classes)
    export = np.argmax(hard, axis=0).transpose(2, 0, 1).astype(np.uint8)
    return torch.from_numpy(hard[None]).to(predict.device), target, export
