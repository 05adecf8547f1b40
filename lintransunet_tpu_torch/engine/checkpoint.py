"""Checkpoints with ``torch.save`` (port of
``lintransunet_tpu/engine/checkpoint.py``), under the JAX package's
artifact names: the CLIs write ``temp_model`` (the best parameters,
``save_params``), ``train_state`` (``save_train_state``) and ``model``
(``save_checkpoint`` of the final parameters). Each is one file; a
temporary name is renamed into place, so a reader never sees a
half-written one. The JAX package's orbax directories are not readable
here; the reference's own ``torch.save`` state_dicts load through
``compat.load_reference_state_dict``.

A full train state holds everything a resume needs: the parameters, the
optimizer's moments and step counts, the micro-step count, the
accumulation state (``mini_step``, ``gradient_step``, ``acc_grads``) and a
small ``aux`` dict from the caller (epoch, best eval loss, the plateau
scheduler's ``state_dict()``). Restoring it into a state built the same
way continues bit for bit where the saved run stopped; the reference's
params-only ``torch.save`` (utils_3D_embed_full.py:171-175) restarted the
moments and every schedule.
"""

import os
from typing import Any, Mapping, Optional, Tuple

import torch

from lintransunet_tpu_torch.engine.train import TrainState


def _save(obj: Any, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str, map_location=None):
    return torch.load(path, map_location=map_location, weights_only=True)


def save_checkpoint(path: str, state: Any, aux: Optional[dict] = None) -> None:
    """Save ``state`` (tensors in dicts, lists and numbers) and an optional
    small ``aux`` dict to ``path``."""
    payload = {"state": state}
    if aux is not None:
        payload["aux"] = aux
    _save(payload, path)


def restore_checkpoint(path: str, map_location=None) -> dict:
    """{"state": ..., and "aux" if one was saved} from ``save_checkpoint``."""
    return _load(path, map_location)


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """Params-only artifact, a model's ``state_dict()`` as it is (the
    analogue of the reference's ``temp_model.pt``)."""
    _save(dict(params), path)


def restore_params(path: str, map_location=None) -> dict:
    """The state_dict of ``save_params``, for ``model.load_state_dict``."""
    return _load(path, map_location)


def save_train_state(path: str, state: TrainState, aux: Optional[dict] = None) -> None:
    """Write ``state`` (and ``aux``) to ``path``."""
    _save({
        "params": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step_times": state.step_times,
        "step": state.step,
        "mini_step": state.mini_step,
        "gradient_step": state.gradient_step,
        "acc_grads": state.acc_grads,
        "aux": aux or {},
    }, path)


def restore_train_state(path: str, state: TrainState) -> Tuple[TrainState, dict]:
    """Load ``path`` into ``state`` (its model and optimizer, built as the
    saved ones were, on any device) in place. Returns (state, aux)."""
    payload = _load(path, next(state.model.parameters()).device)
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
