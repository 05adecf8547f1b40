"""Full-train-state checkpoints with ``torch.save`` (port of
``save_train_state`` / ``restore_train_state``,
``lintransunet_tpu/engine/checkpoint.py:37-71``).

Everything a resume needs goes into one file: the parameters, the
optimizer's moments and step counts, the micro-step count, the
accumulation state (``mini_step``, ``gradient_step``, ``acc_grads``) and a
small ``aux`` dict from the caller (epoch, best eval loss, the plateau
scheduler's ``state_dict()``). Restoring it into a state built the same
way continues bit for bit where the saved run stopped; the reference's
params-only ``torch.save`` (utils_3D_embed_full.py:171-175) restarted the
moments and every schedule.
"""

import os
from typing import Optional, Tuple

import torch

from lintransunet_tpu_torch.engine.train import TrainState


def save_train_state(path: str, state: TrainState, aux: Optional[dict] = None) -> None:
    """Write ``state`` (and ``aux``) to ``path``; a temporary name is renamed
    into place, so a reader never sees a half-written file."""
    payload = {
        "params": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step_times": state.step_times,
        "step": state.step,
        "mini_step": state.mini_step,
        "gradient_step": state.gradient_step,
        "acc_grads": state.acc_grads,
        "aux": aux or {},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str, state: TrainState) -> Tuple[TrainState, dict]:
    """Load ``path`` into ``state`` (its model and optimizer, built as the
    saved ones were, on any device) in place. Returns (state, aux)."""
    device = next(state.model.parameters()).device
    payload = torch.load(path, map_location=device, weights_only=True)
    if payload["step_times"] != state.step_times:
        raise ValueError(f"the checkpoint accumulates {payload['step_times']} "
                         f"micro-steps, this state {state.step_times}")
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = payload["step"]
    state.mini_step = payload["mini_step"]
    state.gradient_step = payload["gradient_step"]
    state.acc_grads = payload["acc_grads"]
    return state, payload["aux"]
