"""Load the reference's own PyTorch checkpoints onto the port (port of
``lintransunet_tpu/compat/torch_import.py:convert_state_dict``).

The port's module names are the reference's attribute paths with each
``ModuleList`` / ``Sequential`` index merged into its name
(``decode.block_list.0.conv1.weight`` -> ``decode.block_list_0.conv1.
weight``), and its parameters keep the reference's torch layouts, so a
reference key maps onto a port key by that merge alone, with no transpose.

* BatchNorm buffers (``running_mean``, ``running_var``,
  ``num_batches_tracked``; the reference's only BatchNorm sits in the dead
  ``SolidBlock``) and keys with no target in the port (the reference's dead
  ``pos_encoders_1..N`` clones, which its forward never touches) are
  skipped and reported;
* a leaf other than ``weight``, ``bias`` or those buffers, and a shape that
  differs from the port's, raise ``ValueError``.

Parameters of the port that the checkpoint does not name keep their values.
"""

import logging
from typing import List, Mapping

import torch
from torch import nn

_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def port_key(reference_key: str) -> str:
    """'decode.block_list.0.conv1.weight' -> 'decode.block_list_0.conv1.weight'."""
    merged: List[str] = []
    for part in reference_key.split("."):
        if part.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{part}"
        else:
            merged.append(part)
    return ".".join(merged)


def load_reference_state_dict(model: nn.Module, state: Mapping) -> List[str]:
    """Copy a reference state_dict (tensors or arrays) into ``model``'s
    parameters in place, as f32 on their device; return the skipped keys."""
    target = model.state_dict()
    updates, skipped = {}, []
    for key, value in state.items():
        leaf = key.rsplit(".", 1)[-1]
        if leaf in _BUFFERS:
            skipped.append(key)
            continue
        if leaf not in ("weight", "bias"):
            raise ValueError(f"unhandled torch leaf {leaf!r} in {key}")
        name = port_key(key)
        if name not in target:
            skipped.append(key)
            continue
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(target[name].shape):
            raise ValueError(f"shape mismatch for {key}: reference {tuple(value.shape)} "
                             f"vs port {tuple(target[name].shape)} at {name}")
        updates[name] = value.to(torch.float32)
    target.update(updates)
    model.load_state_dict(target)
    if skipped:
        logging.getLogger(__name__).info(
            "load_reference_state_dict skipped %d keys: %s", len(skipped), skipped[:8])
    return skipped
