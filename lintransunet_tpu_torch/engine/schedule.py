"""Schedules: the deep-supervision weight warmup and the plateau scheduler
(the port's own copy of ``lintransunet_tpu/engine/schedule.py``).

``get_weight`` mirrors utils/utils_3D_embed_full.py:16-19:
    w(t) = min(initial + default * exp(t / (5T)), final), t clamped at 0.
``get_dynamic_weight`` builds the per-epoch 5-level weight table
(train3D.py:122-137). ``ReduceLROnPlateau`` is the JAX package's
plateau scheduler, field for field and branch for branch, as plain
host-side state: the caller writes the LR that ``step`` returns into the
optimizer with ``set_learning_rate``.
"""

import dataclasses
import math
from typing import List, Sequence


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


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Plateau LR schedule (mode 'min', relative threshold) with the
    reference's defaults (train3D.py:195-201): factor 0.8, patience 5,
    threshold 1e-2, cooldown 1, min_lr 1e-7.

    It follows the JAX package's scheduler, not torch's: an epoch that
    improves during a cooldown leaves ``cooldown_counter`` as it is (torch
    counts it down there too), so after a reduction and an improvement the
    next reduction comes one epoch later than torch's. ``state_dict()`` is
    plain data; ``ReduceLROnPlateau(**state_dict())`` resumes it.
    """

    lr: float
    factor: float = 0.8
    patience: int = 5
    threshold: float = 1e-2
    cooldown: int = 1
    min_lr: float = 1e-7

    best: float = float("inf")
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def step(self, metric: float) -> float:
        """Take one eval's metric; return the LR for the next epoch."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad_epochs = 0
        return self.lr
