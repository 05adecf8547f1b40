"""The general traffic generator: every input of a run drawn from its seed
by the parameters of a traffic file (``traffic/<mix>.json``).

Volumes are CT phantoms drawn on the card: an elliptic body of soft tissue
in a rim of fat, in air, with ellipsoid organs of fixed Hounsfield levels
and Gaussian noise, clipped to the dataset's HU window and normalised by its
mean and std, as the dataset's cache holds volumes. The same seed gives the
same volumes, weights and orders; every seed gives the same set of sizes.
"""

import json
import os
from typing import Dict, List

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, kind, f"{name}.json")) as f:
        return json.load(f)


def substream(seed: int, *path: int) -> int:
    """A 63-bit seed of its own for each (seed, path): weights, inputs,
    orders and dropout draw from separate streams of one run seed."""
    return int(np.random.SeedSequence([seed % (1 << 64), *path]).generate_state(
        2, np.uint64)[0] >> np.uint64(1))


def phantom(generator: torch.Generator, shape, params: dict, device) -> torch.Tensor:
    """One normalised (H, W, D) f32 phantom on ``device``."""
    h, w, d = shape
    r = lambda *s: torch.rand(s, generator=generator, device=device)
    x = torch.linspace(-1, 1, h, device=device).view(-1, 1, 1)
    y = torch.linspace(-1, 1, w, device=device).view(1, -1, 1)
    z = torch.linspace(-1, 1, d, device=device).view(1, 1, -1)
    lo, hi = params["body_axes"]
    a = lo[0] + (hi[0] - lo[0]) * r(1)
    b = lo[1] + (hi[1] - lo[1]) * r(1)
    body = (x / a) ** 2 + (y / b) ** 2
    hu = torch.full(shape, float(params["air_hu"]), device=device)
    hu = torch.where(body < 1.0, torch.tensor(float(params["fat_hu"]), device=device), hu)
    inner = body < params["tissue_fraction"]
    hu = torch.where(inner, torch.tensor(float(params["tissue_hu"]), device=device), hu)
    levels = params["organ_hu"]
    smin = torch.tensor(params["organ_axes_min"], device=device)
    sspan = torch.tensor(params["organ_axes_span"], device=device)
    for k in range(params["organs"]):
        c = (r(3) - 0.5) * torch.cat([1.2 * a, 1.2 * b, torch.ones(1, device=device) * 1.6])
        s = smin + r(3) * sspan
        inside = ((x - c[0]) / s[0]) ** 2 + ((y - c[1]) / s[1]) ** 2 + ((z - c[2]) / s[2]) ** 2
        hu = torch.where((inside < 1.0) & inner,
                         torch.tensor(float(levels[k % len(levels)]), device=device), hu)
    hu = hu + params["noise_hu"] * torch.randn(shape, generator=generator, device=device)
    low, high = params["hu_window"]
    return (hu.clamp(low, high) - params["mean"]) / params["std"]


def worklist(seed: int, traffic: dict, device) -> List[np.ndarray]:
    """The replay list: one channels-last (1, H, W, D, 1) f32 host volume
    for each depth of the mix, drawn on ``device`` and copied to pageable
    host memory, in the order the seed shuffles them to."""
    g = torch.Generator(device=device).manual_seed(substream(seed, 1))
    h, w = traffic["height"], traffic["width"]
    order = np.random.default_rng(substream(seed, 2)).permutation(len(traffic["depths"]))
    volumes = []
    for i in order:
        vol = phantom(g, (h, w, traffic["depths"][i]), traffic["phantom"], device)
        volumes.append(vol[None, ..., None].cpu().numpy())
    return volumes


def patches(seed: int, traffic: dict, count: int, device) -> Dict[str, torch.Tensor]:
    """``count`` training patches (N, 1, H, W, D) f32 on ``device``, all
    different phantoms, and the label every patch has, (1, H, W, D) int64:
    1 in the mix's box."""
    g = torch.Generator(device=device).manual_seed(substream(seed, 3))
    shape = tuple(traffic["patch"])
    images = torch.stack([phantom(g, shape, traffic["phantom"], device) for _ in range(count)])
    label = torch.zeros((1,) + shape, dtype=torch.long, device=device)
    label[(slice(None),) + tuple(slice(lo, hi) for lo, hi in traffic["label_box"])] = 1
    return {"images": images[:, None].contiguous(), "label": label}


def window_count(depth: int, window: int, overlap: float) -> int:
    """Windows along a depth in the sliding-window grid (the others span the
    whole slice): starts every int(window * (1 - overlap)) slices, the last
    clipped to depth - window."""
    if depth <= window:
        return 1
    interval = max(int(window * (1 - overlap)), 1)
    return -(-(depth - window) // interval) + 1
