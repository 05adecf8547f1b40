"""Shared CLI plumbing (port of ``get_criterion_list`` and
``make_eval_runner``, ``lintransunet_tpu/cli/common.py:10-29, 45-62``); the
CLIs themselves come later."""

import dataclasses
from typing import List, Tuple

from torch import nn


def get_criterion_list(num_levels: int, criterion_list, loss_module=None
                       ) -> Tuple[List[dict], dict]:
    """Per-level criterion schedule (train3D.py:139-155): CE + BalanceDice
    on the low levels, CE + DiceClass on the second from the top, the
    configured list on the top (full-resolution) level; and the eval suite
    of train3D.py:144. ``loss_module`` defaults to the port's binary
    losses."""
    if loss_module is None:
        from lintransunet_tpu_torch.losses import binary as loss_module
    temp_list = ["CrossEntroLoss", "BalanceDiceLoss"]
    temp_list2 = ["CrossEntroLoss", "DiceClassLoss"]
    eval_list = ["BalanceDiceLoss", "DiceClassLoss", "RecallLoss",
                 "PrecisionLoss", "LocalizationLoss"]
    criterions = []
    for i in range(num_levels):
        if i < num_levels - 2:
            criterions.append(loss_module.get_criterions(temp_list))
        elif i == num_levels - 2:
            criterions.append(loss_module.get_criterions(temp_list2))
        else:
            criterions.append(loss_module.get_criterions(list(criterion_list)))
    return criterions, loss_module.get_criterions(eval_list)


@dataclasses.dataclass
class EvalConfig:
    """Eval-time sliding-window geometry (utils_3D_embed_full.py:135-148);
    the sliding-window fields of ``lintransunet_tpu.core.config.EvalConfig``,
    which ``make_eval_runner`` accepts as well."""

    roi_size: int = 512
    depth_size: int = 64
    overlap: float = 0.6
    mode: str = "constant"  # sigma_scale=0 + constant blending


def make_eval_runner(model: nn.Module, cfg, sw_batch_size: int = 1):
    """(eval_forward, SlidingWindowRunner) from an eval config: a square
    ``roi_size`` x ``roi_size`` x ``depth_size`` window, the config's overlap
    and blend mode, and the background derived from the fg-only forward.
    The runner works on the model's device: a volume given elsewhere is
    moved there."""
    from lintransunet_tpu_torch import engine

    eval_fwd = engine.make_eval_forward(model)
    runner = engine.SlidingWindowRunner(
        eval_fwd, roi_size=(cfg.roi_size, cfg.roi_size, cfg.depth_size),
        sw_batch_size=sw_batch_size, overlap=cfg.overlap, mode=cfg.mode,
        derive_background=eval_fwd.fg_only,
        device=next(model.parameters()).device)
    return eval_fwd, runner
