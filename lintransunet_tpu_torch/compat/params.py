"""Parameters and activations between the JAX package and this port.

``from_flax`` is the exact inverse of the JAX package's ``_convert_leaf``
(``lintransunet_tpu/compat/torch_import.py:38-56``): this port's module
names equal the flax names, so a flax path ``a/b_0/c/kernel`` becomes the
state_dict key ``a.b_0.c.weight``, with

* conv kernel (k..., I, O) -> weight (O, I, k...)
* Dense kernel (I, O)      -> weight (O, I)
* LayerNorm / BatchNorm scale -> weight
* bias                     -> bias

and, from the ``batch_stats`` collection, a BatchNorm's running mean and
var -> ``running_mean`` and ``running_var`` (``blocks.BatchNorm``'s
buffers).
"""

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def _to_torch_leaf(name: str, value: np.ndarray):
    if name == "kernel":
        if value.ndim >= 3:
            perm = (value.ndim - 1, value.ndim - 2) + tuple(range(value.ndim - 2))
            return "weight", value.transpose(perm)
        if value.ndim == 2:
            return "weight", value.T
        raise ValueError(f"kernel of rank {value.ndim} has no torch layout")
    if name == "scale":
        return "weight", value
    if name == "bias":
        return "bias", value
    raise ValueError(f"unhandled flax leaf {name!r}")


_STATS = {"mean": "running_mean", "var": "running_var"}


def _stats_leaf(name: str, value: np.ndarray):
    if name not in _STATS:
        raise ValueError(f"unhandled flax batch_stats leaf {name!r}")
    return _STATS[name], value


def from_flax(params: Mapping, batch_stats: Mapping = None) -> Dict[str, torch.Tensor]:
    """Nested flax ``params`` (numpy-convertible leaves), and the
    ``batch_stats`` collection of a model with BatchNorm, -> f32 state_dict."""
    out = {}

    def walk(node, prefix, leaf):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (key,), leaf)
                continue
            name, arr = leaf(key, np.asarray(value))
            out[".".join(prefix + (name,))] = torch.from_numpy(
                np.ascontiguousarray(arr, dtype=np.float32))

    walk(params, (), _to_torch_leaf)
    walk(batch_stats or {}, (), _stats_leaf)
    return out


def _permute(x, perm):
    if isinstance(x, torch.Tensor):
        return x.permute(perm)
    return np.transpose(np.asarray(x), perm)


def from_ncdhw(x):
    """Reference layout (N, C, H, W, D) -> JAX layout (N, H, W, D, C)."""
    return _permute(x, (0, 2, 3, 4, 1))


def to_ncdhw(x):
    """JAX layout (N, H, W, D, C) -> reference layout (N, C, H, W, D)."""
    return _permute(x, (0, 4, 1, 2, 3))
