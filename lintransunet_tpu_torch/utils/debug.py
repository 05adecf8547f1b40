"""Numerics debugging: NaN and Inf guards (port of
``lintransunet_tpu/utils/debug.py``).

The reference debugged NaNs with inline isnan prints
(Unet_3Dblock_m.py:321-325, loss/criterions.py:722-734) and a commented-out
``torch.autograd.set_detect_anomaly`` (train3D.py:158). Here:

* global mode: ``enable_nan_debugging()``, anomaly detection, which names the
  backward op that produced the first NaN (JAX's ``jax_debug_nans``);
* targeted guards: ``nan_guard`` on one tensor, ``finite_check`` on a model
  or a tree of tensors at an epoch boundary.

Each guard reads the device once where it is called (a host sync); no path
of the package calls one.
"""

from typing import Any, Iterator

import torch
from torch import nn


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def nan_guard(x: torch.Tensor, label: str) -> torch.Tensor:
    """Identity that prints when ``x`` has non-finite values: one reduction
    and one host read of its result."""
    if not bool(torch.isfinite(x).all()):
        print(f"[nan_guard] non-finite values in {label}")
    return x


def finite_check(tree: Any) -> bool:
    """Host-side: True iff every floating tensor of ``tree`` (a module's
    parameters and buffers, a tensor, or dicts, lists and tuples of them)
    is finite."""
    flags = [torch.isfinite(t).all() for t in _tensors(tree) if t.is_floating_point()]
    return all(bool(f) for f in flags)


def enable_nan_debugging() -> None:
    """Global abort-on-NaN mode: autograd's anomaly detection raises in the
    backward op that first gives a NaN and shows its forward's traceback."""
    torch.autograd.set_detect_anomaly(True)
