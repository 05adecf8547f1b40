"""Shared CLI plumbing (port of ``lintransunet_tpu/cli/common.py``): the
criterion schedule, the eval runner, the model factory, the per-volume
predictions (``engine.loop.batched_predictions``, which the eval loop
iterates too), the run directories, and the data-parallel mesh of a run
under ``torchrun`` (``cli_mesh``)."""

import os
import time
from typing import List, Tuple

from torch import nn

from lintransunet_tpu_torch.core.config import EvalConfig, ModelConfig
from lintransunet_tpu_torch.engine.loop import batched_predictions

__all__ = ["EvalConfig", "get_criterion_list", "get_multi_criterion_list",
           "make_eval_runner", "build_model", "batched_predictions", "run_dirs",
           "cli_mesh"]


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


def get_multi_criterion_list(num_levels: int, criterion_list, loss_module=None
                             ) -> Tuple[List[dict], dict]:
    """Multi-class schedule (train3D_multi_class.py:139-155): CE + Dice1 +
    Dice2 on every level but the top (full-resolution) one, which takes the
    configured list; the eval suite adds DiceClassLoss0 and the recall and
    precision losses. ``loss_module`` defaults to the port's multi-class
    losses."""
    if loss_module is None:
        from lintransunet_tpu_torch.losses import multiclass as loss_module
    level_list = ["CrossEntroLoss", "DiceClassLoss", "DiceClassLoss2"]
    eval_list = ["DiceClassLoss0", "DiceClassLoss", "DiceClassLoss2",
                 "RecallLoss", "PrecisionLoss"]
    criterions = [loss_module.get_criterions(
        list(criterion_list) if i == num_levels - 1 else level_list)
        for i in range(num_levels)]
    return criterions, loss_module.get_criterions(eval_list)


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


def cli_mesh(args):
    """The data-parallel mesh of a CLI run (``parallel.make_mesh`` on
    ``args.device``) when it runs under ``torchrun`` with more than one
    process or inside a process group its caller initialised, as the JAX
    CLIs build one when ``jax.device_count() > 1``; else None."""
    from lintransunet_tpu_torch import parallel

    if not parallel.distributed_requested():
        return None
    return parallel.make_mesh(device=getattr(args, "device", "cuda"))


def build_model(args, device=None) -> nn.Module:
    """The model of the CLI flags, on ``device`` or else ``args.device`` (the
    card by default)."""
    return ModelConfig(
        model_name=args.model_name,
        num_layers=tuple(args.num_layers),
        roi_size_list=tuple(args.roi_size_list),
        is_roi_list=tuple(args.is_roi_list),
        dim_input=args.dim_input,
        dim_output=args.dim_output,
        kernel_size=args.kernel_size,
        compute_dtype=getattr(args, "compute_dtype", "bfloat16"),
        attn_layers=getattr(args, "attn_layers", 8),
    ).build(device or getattr(args, "device", "cuda"))


def run_dirs(log_dir: str, model_dir: str, fold_num: int):
    stamp = time.strftime("%Y%m%d-%H_%M_%S")
    log = os.path.join(log_dir, stamp, f"fold_{fold_num}")
    model = os.path.join(model_dir, stamp, f"fold_{fold_num}")
    os.makedirs(log, exist_ok=True)
    os.makedirs(model, exist_ok=True)
    return log, model
