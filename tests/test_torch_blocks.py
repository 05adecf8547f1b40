"""PyTorch port vs the JAX package, block by block, in f32 on the CPU.

Each JAX block and its port get the same seeded parameters (via
``from_flax``) and inputs. Tolerance rtol 1e-4 / atol 1e-5: f32 with
sums in another order. ``from_flax`` is also checked on its own: the
port's state_dict, fed through the JAX package's ``convert_state_dict``,
gives back the flax tree it came from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu import models as jm
from lintransunet_tpu.compat import convert_state_dict
from lintransunet_tpu_torch import models as tm
from lintransunet_tpu_torch.compat import from_flax, from_ncdhw, to_ncdhw
from torch_port_helpers import SMALL, load_port, random_params, t

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_self_attention_layer(rng, masked):
    x = rng.standard_normal((2, 50, 64)).astype(np.float32)
    mask = rng.random((2, 50, 1)) > 0.3 if masked else None
    jmod = jm.SelfAttentionLayer(64, 2, 128)
    params = random_params(jmod, x, mask, seed=1)
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      None if mask is None else jnp.asarray(mask))
    port = load_port(tm.SelfAttentionLayer(64, 2, 128), params)
    got = port(t(x), None if mask is None else t(mask))
    _close(got, want)


def test_self_attention_layer_gradient(rng):
    """The port's layer (q, k, v passed to the attention as head-split
    views, no copies) under autograd against ``jax.grad`` of JAX's layer:
    the input's and every parameter's gradient of a weighted sum of the
    output."""
    x = rng.standard_normal((2, 50, 64)).astype(np.float32)
    w = rng.standard_normal((2, 50, 64)).astype(np.float32)
    jmod = jm.SelfAttentionLayer(64, 2, 128)
    params = random_params(jmod, x, None, seed=3)

    def loss(p, xx):
        return jnp.sum(jmod.apply({"params": p}, xx) * jnp.asarray(w))

    grad_params, grad_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    port = load_port(tm.SelfAttentionLayer(64, 2, 128), params)
    xt = t(x).requires_grad_()
    (port(xt) * t(w)).sum().backward()
    _close(xt.grad, grad_x)
    want = from_flax(jax.tree_util.tree_map(np.asarray, grad_params))
    assert set(want) == {name for name, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        _close(p.grad, want[name].numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_pos_attention_block(rng, masked):
    x = rng.standard_normal((1, 4, 6, 3, 64)).astype(np.float32)
    mask = (rng.random((1, 4, 6, 3, 1)) > 0.3).astype(np.float32) if masked else None
    jmod = jm.PosAttention3DBlock(64, 64, 2, n_layers=2)
    params = random_params(jmod, x, seed=2)
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      None if mask is None else jnp.asarray(mask))
    port = load_port(tm.PosAttention3DBlock(64, 64, 2, n_layers=2), params)
    got = port(t(to_ncdhw(x)), None if mask is None else t(to_ncdhw(mask)))
    _close(from_ncdhw(got), want)


def test_embed_attention_block_odd_sizes(rng):
    # odd H, W: the stride-2 embed and nearest up-embed give eval + 1 rows
    x = rng.standard_normal((1, 9, 5, 6, 16)).astype(np.float32)
    jmod = jm.EmbedAttention3DBlock(16, 64, 2, n_layers=2)
    params = random_params(jmod, x, seed=3)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    port = load_port(tm.EmbedAttention3DBlock(16, 64, 2, n_layers=2), params)
    got = port(t(to_ncdhw(x)))
    assert tuple(got.shape[2:]) == (10, 6, 6)
    _close(from_ncdhw(got), want)


def test_roi_bridge(rng):
    x = rng.standard_normal((2, 16, 16, 4, 16)).astype(np.float32)
    mask = rng.random((2, 16, 16, 4, 1)).astype(np.float32)
    mask[1, :8] = 0.0  # a one-sided box
    assert np.min(np.abs(mask - 0.5)) > 1e-5  # no voxel on the bbox threshold
    jmod = jm.ROIBridge(16, 64, 2, n_layers=2, roi_size=8)
    params = random_params(jmod, x, mask, seed=4)
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    port = load_port(tm.ROIBridge(16, 64, 2, n_layers=2, roi_size=8), params)
    got = port(t(to_ncdhw(x)), t(to_ncdhw(mask)))
    _close(from_ncdhw(got), want)


def test_from_flax_inverts_convert_state_dict():
    """Port state_dict -> JAX convert_state_dict -> the original flax tree:
    every torch key lands on exactly one flax leaf and nothing is skipped."""
    jmodel = jm.MaskTransUnet(**SMALL, n_layers=2)
    params = random_params(jmodel, jnp.zeros((1, 64, 64, 8, 1)), train=False)
    port = load_port(tm.MaskTransUnet(**SMALL, n_layers=2, device="cpu"), params)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    leaves = jax.tree_util.tree_leaves(params)
    assert len(state) == len(leaves)
    nan_tree = jax.tree_util.tree_map(lambda a: np.full_like(a, np.nan), params)
    back = convert_state_dict(state, nan_tree)
    back_leaves = jax.tree_util.tree_leaves(back)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for got, want in zip(back_leaves, leaves):
        np.testing.assert_array_equal(np.asarray(got), want)
