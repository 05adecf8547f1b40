"""The port's binary losses against the JAX package's, in f32 on the CPU.

This is the loss oracle of the port: every entry of ``Loss_Dict`` on the
same seeded softmax predictions and binary labels, channels-last for JAX,
channels-first for the port, with the labels given as (N, H, W, D) ids and
as (N, H, W, D, 1) / (N, 1, H, W, D) maps; then the three classes outside
the registry (``RegionDiceClassLoss``, ``MaskLoss``, ``RegionCrossEntroLoss``)
the same way, and the multi-class module's aliases of two of them.
Tolerance: rtol 1e-5 (sums of a few hundred f32 values in another order),
atol 1e-7 for values near 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.losses import binary as jax_binary
from lintransunet_tpu.losses import multiclass as jax_multiclass
from lintransunet_tpu_torch.losses import binary, functional, multiclass
from torch_port_helpers import t

NAMES = sorted(jax_binary.Loss_Dict)
SHAPE = (2, 6, 5, 4)  # (N, H, W, D)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(SHAPE + (2,)).astype(np.float32) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(axis=-1, keepdims=True)
    labels = (rng.random(SHAPE) < 0.3).astype(np.int32)
    return probs, labels


def test_registry_names_match():
    assert sorted(binary.Loss_Dict) == NAMES and len(NAMES) == 16
    got = binary.get_criterions(["CrossEntroLoss", "DiceClassLoss"])
    assert list(got) == ["CrossEntroLoss", "DiceClassLoss"]
    assert isinstance(got["CrossEntroLoss"], binary.CrossEntroLoss)


@pytest.mark.parametrize("labels_as", ["ids", "map"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax(name, labels_as):
    probs, labels = _inputs(sum(map(ord, name)))
    jax_labels, port_labels = labels, labels
    if labels_as == "map":
        jax_labels, port_labels = labels[..., None], labels[:, None]
    want = float(jax_binary.Loss_Dict[name]()(jnp.asarray(probs), jnp.asarray(jax_labels)))
    got = binary.Loss_Dict[name]()(t(np.moveaxis(probs, -1, 1)), t(port_labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-7)


# the classes outside Loss_Dict; MaskLoss reads channel 0, so it is given the
# class-1 channel alone, as JAX's tests/test_losses.py:118 gives it
UNREGISTERED = ["RegionDiceClassLoss", "MaskLoss", "RegionCrossEntroLoss"]


@pytest.mark.parametrize("labels_as", ["ids", "map"])
@pytest.mark.parametrize("name", UNREGISTERED)
def test_unregistered_loss_matches_jax(name, labels_as):
    probs, labels = _inputs(sum(map(ord, name)))
    if name == "MaskLoss":
        probs = probs[..., 1:]
    jax_labels, port_labels = labels, labels
    if labels_as == "map":
        jax_labels, port_labels = labels[..., None], labels[:, None]
    assert name not in binary.Loss_Dict
    want = float(getattr(jax_binary, name)()(jnp.asarray(probs), jnp.asarray(jax_labels)))
    got = getattr(binary, name)()(t(np.moveaxis(probs, -1, 1)), t(port_labels))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-7)


def test_multiclass_module_reexports_the_binary_classes():
    for name in ("RegionDiceClassLoss", "MaskLoss", "DistributionLoss"):
        assert getattr(jax_multiclass, name) is getattr(jax_binary, name)
        assert getattr(multiclass, name) is getattr(binary, name)


def test_functional_helpers():
    probs, labels = _inputs(0)
    tokens = functional.flatten_tokens(t(np.moveaxis(probs, -1, 1)))
    np.testing.assert_array_equal(tokens.numpy(), probs.reshape(2, -1, 2))
    flat = functional.flatten_labels(t(labels))
    np.testing.assert_array_equal(functional.binary_onehot(flat).numpy(),
                                  functional.one_hot(flat, 2).numpy())
