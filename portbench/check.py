"""What decides ``correct``: the numbers that hold the program's outputs to
the plain reference, each beside its limit (``limits/<cell>.json``).

Serving. For each sampled volume the reference blends its own windows in
f32 and thresholds them; where the served mask disagrees with the
reference's mask, the voxel counts the distance of the reference's blended
class-1 probability from the 0.5 tie. A volume's wrong-side mean is the
mean of that distance over its voxels: a voxel served on the wrong side of
a near-tie weighs little, one where the reference was sure weighs much.
``wrong_side_median`` is the median over the sampled volumes: one volume
whose ROI box moved by a pixel under bf16 rounding (a discrete step of the
model that then shifts the whole bridge's output) reads like the control,
and the median leaves it out.

Training. The reference follows the program's first ``check_steps``
micro-steps from the same weights, inputs, level weights and dropout seed.
``loss_gap``: the largest relative gap of a micro-step's loss. Per leaf,
the gap between the program's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf: ``grad_median``
over the leaves, of the first gradient the optimizer got (its first moment
after the first update over 1 - beta1), and ``change_worst`` of the
parameters' change over the micro-steps. Leaves whose reference gradient is
under a thousandth of the median leaf's (a bias before an InstanceNorm:
nought but rounding) are left out. ``grad_worst``, the worst leaf's first
gradient, is printed and not compared: its leaf is a one-channel gate
convolution whose gradient sums millions of nearly cancelling terms, and
sound bf16 runs read it at 0.2-0.45, where the control reads no higher.
"""

import json
import os
import statistics
from typing import Dict, List

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BETA1 = 0.9
NOUGHT = 1e-3


def limits(cell: str) -> dict:
    with open(os.path.join(ROOT, "limits", f"{cell}.json")) as f:
        return {k: v for k, v in json.load(f).items() if not k.startswith("_")}


def judge(values: Dict[str, float], cell: str):
    """(correct, {name: {"value", "limit"}}): every value at or under its
    limit; a value that is not a finite number fails."""
    lim = limits(cell)
    checks = {name: {"value": float(values[name]), "limit": lim[name]} for name in lim}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks


class ServeTally:
    """Each sampled volume's wrong-side mean and disagreement share; their
    median, and the mean over every voxel of the sample, reported beside it."""

    def __init__(self):
        self.volumes: List[tuple] = []  # (voxels, summed distance, disagreeing voxels)

    def add(self, served: torch.Tensor, reference: torch.Tensor, soft: torch.Tensor,
            threshold: float):
        wrong = (served.to(reference.device) >= threshold) != (reference >= threshold)
        self.volumes.append((wrong.numel(), float(((soft - threshold).abs() * wrong).sum()),
                             int(wrong.sum())))

    def values(self) -> Dict[str, float]:
        voxels = sum(v[0] for v in self.volumes)
        return {"wrong_side_median": statistics.median(v[1] / v[0] for v in self.volumes),
                "wrong_side_mean": sum(v[1] for v in self.volumes) / voxels,
                "disagree_share": sum(v[2] for v in self.volumes) / voxels,
                "per_volume": [round(v[1] / v[0], 7) for v in self.volumes]}


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], keep: List[str]):
    """{leaf: gap} of the kept leaves."""
    median = statistics.median(reference[n] for n in keep)
    return {n: abs(program[n] - reference[n]) / max(reference[n], median) for n in keep}


def train_values(program: dict, reference: dict) -> Dict[str, float]:
    """``program`` and ``reference``: {"losses": [...], "grads": {leaf:
    norm}, "changes": {leaf: norm}}."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], reference["losses"]))
    grads = reference["grads"]
    median = statistics.median(grads.values())
    keep = [n for n, g in grads.items() if g >= NOUGHT * median]
    g = leaf_gaps(program["grads"], grads, keep)
    c = leaf_gaps(program["changes"], reference["changes"], keep)
    worst = max(g, key=g.get)
    return {"loss_gap": loss_gap, "grad_worst": g[worst], "grad_worst_leaf": worst,
            "grad_median": statistics.median(g.values()), "change_worst": max(c.values()),
            "change_worst_leaf": max(c, key=c.get), "leaves_left_out": len(grads) - len(keep)}


def first_gradients(named_params, optimizer) -> Dict[str, float]:
    """Each leaf's norm of the first gradient its optimizer stepped on, from
    AdamW's first moment after one update."""
    out = {}
    for name, p in named_params:
        state = optimizer.state.get(p, {})
        out[name] = float(state["exp_avg"].norm() / (1 - BETA1)) if "exp_avg" in state else 0.0
    return out
