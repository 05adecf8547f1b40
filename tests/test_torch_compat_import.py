"""The loader of the reference's own checkpoints onto the port
(``compat.load_reference_state_dict``), against ``from_flax``: a
reference-form state_dict (the port's keys with each list index split off,
``block_list_0`` -> ``block_list.0``) of the SMALL model's parameters loads
to the tensors ``from_flax`` gives; a BatchNorm buffer and a dead
``pos_encoders_2`` key are skipped and reported; a wrong shape raises."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.compat.torch_import import _flax_path
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu_torch.compat import from_flax, load_reference_state_dict
from lintransunet_tpu_torch.compat.torch_import import port_key
from lintransunet_tpu_torch.models import MaskTransUnet
from torch_port_helpers import SMALL, random_params


def reference_key(key):
    """'decode.block_list_0.conv1.weight' -> 'decode.block_list.0.conv1.weight'."""
    return re.sub(r"_(\d+)(?=\.)", r".\1", key)


@pytest.fixture(scope="module")
def flax_state():
    jmodel = JaxMaskTransUnet(**SMALL, n_layers=2)
    return from_flax(random_params(jmodel, jnp.zeros((1, 64, 64, 8, 1)), train=False, seed=2))


def _reference_form(state):
    ref = {reference_key(k): v.clone() for k, v in state.items()}
    dead = next(k for k in ref if ".pos_encoders.0." in k).replace(".pos_encoders.0.",
                                                                   ".pos_encoders.2.")
    ref[dead] = torch.ones(ref[dead.replace(".pos_encoders.2.", ".pos_encoders.0.")].shape)
    ref["encode.block_list.0.bn.running_mean"] = torch.zeros(8)
    return ref, [dead, "encode.block_list.0.bn.running_mean"]


def test_port_key_is_the_jax_merge(flax_state):
    for key in flax_state:
        ref = reference_key(key)
        path, leaf = _flax_path(ref)
        assert port_key(ref) == ".".join(path + [leaf]) == key


def test_reference_checkpoint_loads_like_from_flax(flax_state):
    ref, extra = _reference_form(flax_state)
    model = MaskTransUnet(**SMALL, n_layers=2, device="cpu")
    skipped = load_reference_state_dict(model, {k: v.numpy() for k, v in ref.items()})
    assert sorted(skipped) == sorted(extra)
    got = model.state_dict()
    assert set(got) == set(flax_state)
    for name, value in flax_state.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], value), name


def test_reference_checkpoint_with_a_wrong_shape_raises(flax_state):
    ref, _ = _reference_form(flax_state)
    key = "decode.final_block.weight"
    assert key in ref
    ref[key] = torch.zeros(ref[key].shape[:-1] + (ref[key].shape[-1] + 1,))
    model = MaskTransUnet(**SMALL, n_layers=2, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape mismatch"):
        load_reference_state_dict(model, ref)
    for name, value in model.state_dict().items():  # nothing was loaded
        assert torch.equal(value, before[name])


def test_reference_checkpoint_with_an_unknown_leaf_raises(flax_state):
    ref, _ = _reference_form(flax_state)
    ref["decode.final_block.in_proj_weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unhandled torch leaf"):
        load_reference_state_dict(MaskTransUnet(**SMALL, n_layers=2, device="cpu"), ref)
