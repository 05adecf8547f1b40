"""Shared loss math over (N, S, C) token layouts (port of
``lintransunet_tpu/losses/functional.py``).

The port's predictions are channels-first, ``(N, C, spatial...)``; these
helpers flatten them to the JAX package's ``(N, S, C)`` with S in the same
(H, W, D) order, so every loss below is the JAX one line for line.
"""

import torch
import torch.nn.functional as F


def flatten_tokens(x: torch.Tensor) -> torch.Tensor:
    """(N, C, spatial...) -> (N, S, C) in float32."""
    return x.reshape(x.shape[0], x.shape[1], -1).transpose(1, 2).float()


def flatten_labels(t: torch.Tensor) -> torch.Tensor:
    """(N, spatial...) or (N, 1, spatial...) -> (N, S) float32 class ids."""
    return t.reshape(t.shape[0], -1).float()


def binary_onehot(target: torch.Tensor) -> torch.Tensor:
    """(N, S) {0, 1} -> (N, S, 2) via stack([1 - t, t]): the reference's
    memory-saving one-hot (loss/criterions.py:27, :710), valid for binary
    labels only, as there."""
    return torch.stack([1.0 - target, target], dim=-1)


def one_hot(target: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(N, S) integer ids -> (N, S, C) float32."""
    return F.one_hot(target.long(), n_classes).float()


def one_hot_map(target: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(N, spatial...) integer ids -> (N, C, spatial...) float32: the
    channels-first one-hot targets of the multi-class criterions."""
    return F.one_hot(target.long(), n_classes).movedim(-1, 1).float()
