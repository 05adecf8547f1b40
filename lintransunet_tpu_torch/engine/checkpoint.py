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
    _load_optimizer(state.optimizer, payload["optimizer"])
    state.step = payload["step"]
    state.mini_step = payload["mini_step"]
    state.gradient_step = payload["gradient_step"]
    state.acc_grads = _into(state.acc_grads, payload["acc_grads"])
    return state, payload["aux"]


def _into(held, loaded):
    """The saved tensors ``loaded`` written into the tensors ``held`` and
    ``held`` returned (zeros where none was saved: the state a missing one
    stands for, no accumulation, AdamW's first moments); ``loaded`` where
    nothing is held. Raises where they differ in number or shape: a train
    step's captured graphs read ``held`` (``engine.train``), and would go on
    reading it beside a replacement."""
    if held is None:
        return loaded
    if loaded is not None and (len(held) != len(loaded) or any(
            h.shape != v.shape for h, v in zip(held, loaded))):
        raise ValueError(
            f"the checkpoint holds {[tuple(v.shape) for v in loaded]} where the train "
            f"state holds {[tuple(h.shape) for h in held]}")
    with torch.no_grad():
        for i, h in enumerate(held):
            h.zero_() if loaded is None else h.copy_(loaded[i])
    return held


def _load_optimizer(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)``, keeping the tensors the
    optimizer already holds (its moments, step counts and a device learning
    rate) and writing the saved values into them: a train step's captured
    update reads those tensors (``engine.train``). Raises where a held
    tensor has no saved tensor to take."""
    held = {p: {k: v for k, v in s.items() if torch.is_tensor(v)}
            for p, s in optimizer.state.items()}
    rates = [group["lr"] for group in optimizer.param_groups]
    optimizer.load_state_dict(saved)
    for p, tensors in held.items():
        state = optimizer.state[p]
        if state and not all(torch.is_tensor(state.get(k)) for k in tensors):
            raise ValueError(f"the checkpoint's optimizer state {sorted(state)} lacks one of "
                             f"the tensors {sorted(tensors)} that the train state holds")
        state.update(zip(tensors, _into(list(tensors.values()),
                                        [state[k] for k in tensors] if state else None)))
    for group, rate in zip(optimizer.param_groups, rates):
        if torch.is_tensor(rate):
            rate.fill_(float(group["lr"]))
            group["lr"] = rate
