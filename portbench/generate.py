"""The general traffic generator: every input of a run drawn from its seed
by the parameters of a traffic file (``traffic/<mix>.json``).

Volumes are CT phantoms drawn on the card: an elliptic body of soft tissue
in a rim of fat, in air, with ellipsoid organs of fixed Hounsfield levels
and Gaussian noise, clipped to the dataset's HU window and normalised by its
mean and std, as the dataset's cache holds volumes; or, for the inference
CLI, the same phantoms in Hounsfield units written as its eval folder. The
same seed gives the same volumes, weights and orders; every seed gives the
same set of sizes.
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


def phantom_hu(generator: torch.Generator, shape, params: dict, device) -> torch.Tensor:
    """One (H, W, D) f32 phantom in Hounsfield units on ``device``, before any
    window."""
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
    return hu + params["noise_hu"] * torch.randn(shape, generator=generator, device=device)


def phantom(generator: torch.Generator, shape, params: dict, device) -> torch.Tensor:
    """One normalised (H, W, D) f32 phantom on ``device``: clipped to the
    mix's HU window and standardised, as the dataset's cache holds it."""
    low, high = params["hu_window"]
    hu = phantom_hu(generator, shape, params, device)
    return (hu.clamp(low, high) - params["mean"]) / params["std"]


def _replay_phantoms(seed: int, traffic: dict, device):
    """Each depth of the mix's HU phantom, (H, W, D) on ``device``, in the
    order the seed shuffles them to."""
    g = torch.Generator(device=device).manual_seed(substream(seed, 1))
    h, w = traffic["height"], traffic["width"]
    order = np.random.default_rng(substream(seed, 2)).permutation(len(traffic["depths"]))
    for i in order:
        yield phantom_hu(g, (h, w, traffic["depths"][i]), traffic["phantom"], device)


def worklist(seed: int, traffic: dict, device) -> List[np.ndarray]:
    """The replay list: one channels-last (1, H, W, D, 1) f32 host volume
    for each depth of the mix, drawn on ``device`` and copied to pageable
    host memory, in the order the seed shuffles them to."""
    low, high = traffic["phantom"]["hu_window"]
    mean, std = traffic["phantom"]["mean"], traffic["phantom"]["std"]
    return [((hu.clamp(low, high) - mean) / std)[None, ..., None].cpu().numpy()
            for hu in _replay_phantoms(seed, traffic, device)]


def hu_folder(seed: int, traffic: dict, device) -> List[np.ndarray]:
    """The worklist's phantoms as a scanner's export holds them: one (D, H,
    W) int16 host volume in Hounsfield units, rounded, before any window;
    the same draws and order as ``worklist``."""
    return [hu.round().to(torch.int16).permute(2, 0, 1).contiguous().cpu().numpy()
            for hu in _replay_phantoms(seed, traffic, device)]


def eval_window(hu: np.ndarray, window: dict) -> np.ndarray:
    """A (D, H, W) HU volume as the eval dataset hands it to the runner: a
    channels-last (1, H, W, D, 1) f32 volume clipped to the window, less its
    mean, times the reciprocal of its std, in f32 arithmetic."""
    low, high = window["hu_window"]
    x = np.clip(hu.astype(np.float32), np.float32(low), np.float32(high))
    x = (x - np.float32(window["mean"])) * np.float32(1.0 / window["std"])
    return x.transpose(1, 2, 0)[None, ..., None]


def served_volumes(seed: int, traffic: dict, device) -> List[np.ndarray]:
    """The channels-last f32 volumes a serving mix hands the runner, in its
    replay order: the worklist's, or the eval window over the CLI folder's."""
    if traffic["kind"] == "cli":
        return [eval_window(hu, traffic["eval_window"])
                for hu in hu_folder(seed, traffic, device)]
    return worklist(seed, traffic, device)


def write_folder(root: str, volumes: List[np.ndarray], traffic: dict) -> None:
    """The inference CLI's eval layout under ``root``: ``image/<i>.npy``,
    each (D, H, W) HU volume, and ``label/<i>.npy``, (D, H, W) uint8 with 1
    in the mix's box (given as (H, W, D) ranges), ``<i>`` the position in
    the replay list, so that the sorted listing is the replay order."""
    for sub in ("image", "label"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    (h0, h1), (w0, w1), (d0, d1) = traffic["label_box"]
    for i, hu in enumerate(volumes):
        label = np.zeros(hu.shape, np.uint8)
        label[d0:d1, h0:h1, w0:w1] = 1
        np.save(os.path.join(root, "image", f"{i:04d}.npy"), hu)
        np.save(os.path.join(root, "label", f"{i:04d}.npy"), label)


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
