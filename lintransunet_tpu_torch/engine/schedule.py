"""Schedules: the deep-supervision weight warmup and the plateau scheduler
(the port's own copy of ``lintransunet_tpu/engine/schedule.py``).

``get_weight`` mirrors utils/utils_3D_embed_full.py:16-19:
    w(t) = min(initial + default * exp(t / (5T)), final), t clamped at 0.
``get_dynamic_weight`` builds the per-epoch 5-level weight table
(train3D.py:122-137). The plateau scheduler is PyTorch's own, built as
train3D.py:195-201 builds it.
"""

import math
from typing import List, Sequence

import torch


def get_weight(t: float, T: float, default_weight: float = 0.2,
               initial_weight: float = 1.0, final_weight: float = 1.0) -> float:
    t = max(t, 0)
    return float(min(initial_weight + default_weight * math.exp(t / (5 * T)),
                     final_weight))


def get_dynamic_weight(epochs: int, T: float, warmup_step: int,
                       weight_list: Sequence[float],
                       initial_weight: Sequence[float],
                       final_weight: Sequence[float]) -> List[tuple]:
    """Per-epoch tuple of per-level weights (train3D.py:122-137)."""
    out = []
    for i in range(len(weight_list)):
        out.append([
            get_weight(j - warmup_step, T=T, default_weight=weight_list[i],
                       initial_weight=initial_weight[i],
                       final_weight=final_weight[i])
            for j in range(epochs)
        ])
    return list(zip(*out))


def make_plateau_scheduler(optimizer: torch.optim.Optimizer
                           ) -> torch.optim.lr_scheduler.ReduceLROnPlateau:
    """``ReduceLROnPlateau`` with the reference's settings: mode 'min',
    factor 0.8, patience 5, relative threshold 1e-2, cooldown 1, min_lr
    1e-7. ``step(eval_loss)`` after each eval updates the optimizer's LR."""
    return torch.optim.lr_scheduler.ReduceLROnPlateau(
        optimizer, mode="min", factor=0.8, patience=5, threshold=1e-2,
        threshold_mode="rel", cooldown=1, min_lr=1e-7)
