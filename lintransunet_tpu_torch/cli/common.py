"""Shared CLI plumbing (port of ``make_eval_runner``,
``lintransunet_tpu/cli/common.py:45-62``); the CLIs themselves come later."""

import dataclasses

from torch import nn


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
