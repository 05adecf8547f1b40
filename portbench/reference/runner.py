"""The plain sliding-window blend over one volume: windows of the mix's
size at its overlap (MONAI's grid: starts every int(roi * (1 - overlap))
voxels, the last clipped to the end; a dimension the window covers has one
start), ``sw_batch`` windows a forward, constant blending, and the
threshold. A volume smaller than the window is zero-padded symmetrically and
cropped back."""

import math

import torch
import torch.nn.functional as F


def starts(size: int, roi: int, overlap: float):
    if roi >= size:
        return [0]
    interval = max(int(roi * (1 - overlap)), 1)
    count = int(math.ceil((size - roi) / interval)) + 1
    return [min(i * interval, size - roi) for i in range(count)]


@torch.no_grad()
def blend(model, volume: torch.Tensor, traffic: dict, one_hot: bool):
    """(served-like blend, soft blend) of the class-1 channel over a (1, 1,
    H, W, D) volume. ``one_hot``: each window votes 1 where its class-1
    logit beats class 0's (the flagship's eval output); else each window
    gives its class-1 probability. The soft blend always blends the
    probability."""
    roi = tuple(traffic["window"])
    spatial = volume.shape[2:]
    pads = [(max(r - s, 0) // 2, max(r - s, 0) - max(r - s, 0) // 2) for s, r in zip(spatial, roi)]
    x = F.pad(volume, [v for p in reversed(pads) for v in p])
    grid = [(a, b, c) for a in starts(x.shape[2], roi[0], traffic["overlap"])
            for b in starts(x.shape[3], roi[1], traffic["overlap"])
            for c in starts(x.shape[4], roi[2], traffic["overlap"])]
    served = torch.zeros(x.shape[2:], device=x.device)
    soft = torch.zeros_like(served)
    count = torch.zeros_like(served)
    batch = traffic["sw_batch"]
    for i in range(0, len(grid), batch):
        chunk = grid[i:i + batch]
        windows = torch.cat([x[:, :, a:a + roi[0], b:b + roi[1], c:c + roi[2]]
                             for a, b, c in chunk])
        out = model(windows).float()
        if one_hot:
            prob = torch.softmax(out, dim=1)[:, 1]
            vote = (out[:, 1] > out[:, 0]).float()
        else:
            prob = out[:, 1]
            vote = prob
        for j, (a, b, c) in enumerate(chunk):
            region = (slice(a, a + roi[0]), slice(b, b + roi[1]), slice(c, c + roi[2]))
            served[region] += vote[j]
            soft[region] += prob[j]
            count[region] += 1
    crop = tuple(slice(p[0], p[0] + s) for p, s in zip(pads, spatial))
    return (served / count)[crop], (soft / count)[crop]
