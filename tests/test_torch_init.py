"""A freshly built port model initialises as the JAX package's flax model.

flax's ``nn.Conv`` and ``nn.Dense`` (and the JAX package's own projection
params, ``lintransunet_tpu/models/blocks.py:132-134``) draw kernels from
``lecun_normal()``: a normal cut at +-2 of its scale, rescaled so that the
draw has variance 1 / fan_in; biases are zero and LayerNorm scales one. The
flax side here draws each leaf of the SMALL JAX model's parameter tree
(shapes from ``jax.eval_shape``, no real init) with those initialisers and
converts the tree with ``from_flax``; the port side is a fresh
``MaskTransUnet(device="cpu")``, or one refilled by ``init_random_``.

Statistics, not bits (the two draw from different generators):
* per weight of at least 2,000 values, the std within 10% of the flax
  draw's (both are near 1 / sqrt(fan_in), so this holds the fan_in of each
  layout to flax's) and every value within the cut, 2 / 0.8796... of the
  unit-variance scale (the flax draw obeys the same cut);
* pooled over every weight, the values scaled by sqrt(fan_in): mean within
  0.02 of 0, std within 0.01 of the flax draw's, kurtosis within 0.05 of
  the flax draw's (a truncated normal has 2.37, an untruncated one 3, the
  kaiming-uniform default 1.8), the largest within the cut;
* biases zero and LayerNorm scales one, exactly.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu_torch.compat import from_flax
from lintransunet_tpu_torch.models import MaskTransUnet, init_random_, lecun_normal_
from lintransunet_tpu_torch.models.blocks import TRUNCATED_STD
from torch_port_helpers import SMALL

N_LAYERS = 2
CUT = 2.0 / TRUNCATED_STD  # the cut in units of the draw's own std


def _flax_draw(shapes, seed=0):
    """Each leaf drawn as flax initialises it: kernels lecun_normal, biases
    zero, LayerNorm scales one."""
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    drawn = []
    for (path, leaf), key in zip(leaves, keys):
        name = str(path[-1].key)
        if name == "kernel":
            drawn.append(np.asarray(nn.initializers.lecun_normal()(key, leaf.shape)))
        elif name == "bias":
            drawn.append(np.zeros(leaf.shape, np.float32))
        elif name == "scale":
            drawn.append(np.ones(leaf.shape, np.float32))
        else:
            raise AssertionError(f"a parameter flax initialises otherwise: {path}")
    return jax.tree_util.tree_unflatten(tree, drawn)


@pytest.fixture(scope="module")
def flax_state():
    x = jnp.zeros((1, 64, 64, 8, 1), jnp.float32)
    jmodel = JaxMaskTransUnet(**SMALL, n_layers=N_LAYERS)
    shapes = jax.eval_shape(lambda key: jmodel.init(key, x, train=False),
                            jax.random.PRNGKey(0))["params"]
    return from_flax(_flax_draw(shapes))


def _fresh(seed=0):
    torch.manual_seed(seed)
    return MaskTransUnet(**SMALL, n_layers=N_LAYERS, device="cpu")


def _port_state(how):
    model = _fresh()
    if how == "init_random_":
        init_random_(model, torch.Generator().manual_seed(5))
    return {k: v.detach() for k, v in model.state_dict().items()}


def _weights(state):
    return {k: v for k, v in state.items() if v.dim() > 1}


def _pooled(state):
    """Every weight scaled by sqrt(fan_in), as one array."""
    return np.concatenate([(v * v[0].numel() ** 0.5).numpy().ravel()
                           for v in _weights(state).values()])


def _kurtosis(z):
    z = z - z.mean()
    return float((z ** 4).mean() / (z ** 2).mean() ** 2)


def test_port_has_the_flax_tree(flax_state):
    port = _port_state("fresh")
    assert set(port) == set(flax_state)
    assert all(tuple(port[k].shape) == tuple(flax_state[k].shape) for k in port)


@pytest.mark.parametrize("how", ["fresh", "init_random_"])
def test_weights_follow_lecun_normal_per_parameter(flax_state, how):
    port = _port_state(how)
    checked = 0
    for name, w in _weights(port).items():
        want = flax_state[name]
        scale = w[0].numel() ** -0.5
        assert w.abs().max().item() <= CUT * scale * (1 + 1e-5), name
        assert want.abs().max().item() <= CUT * scale * (1 + 1e-5), name
        if w.numel() >= 2000:
            checked += 1
            ratio = w.std().item() / want.std().item()
            assert abs(ratio - 1.0) <= 0.1, (name, ratio)
    assert checked >= 20


@pytest.mark.parametrize("how", ["fresh", "init_random_"])
def test_weights_follow_lecun_normal_pooled(flax_state, how):
    got, want = _pooled(_port_state(how)), _pooled(flax_state)
    assert got.size == want.size > 100_000
    assert abs(got.mean()) <= 0.02 and abs(want.mean()) <= 0.02
    assert abs(got.std() - want.std()) <= 0.01
    assert abs(_kurtosis(got) - _kurtosis(want)) <= 0.05, (_kurtosis(got), _kurtosis(want))
    assert np.abs(got).max() <= CUT * (1 + 1e-5)


@pytest.mark.parametrize("how", ["fresh", "init_random_"])
def test_biases_zero_and_layernorm_scales_one(flax_state, how):
    port = _port_state(how)
    vectors = {k: v for k, v in port.items() if v.dim() == 1}
    assert any(k.endswith("bias") for k in vectors)
    assert any("layer_norm" in k and k.endswith("weight") for k in vectors)
    for name, v in vectors.items():
        assert torch.equal(v, flax_state[name]), name


def test_init_random_is_seeded():
    a, b, c = _fresh(0), _fresh(1), _fresh(2)
    for model, seed in ((a, 3), (b, 3), (c, 4)):
        init_random_(model, torch.Generator().manual_seed(seed))
    wa, wb, wc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert not torch.equal(wa["encode.input_block.weight"], wc["encode.input_block.weight"])


@pytest.mark.parametrize("shape,flax_shape", [
    ((64, 32, 3, 3, 3), (3, 3, 3, 32, 64)),   # a conv: fan_in 32 * 27
    ((128, 1, 3, 3, 3), (3, 3, 3, 1, 128)),   # a depthwise conv (the PEG): fan_in 27
    ((512, 256), (256, 512)),                 # a dense layer: fan_in 256
])
def test_lecun_normal_matches_flax_draw(shape, flax_shape):
    got = lecun_normal_(torch.empty(shape), torch.Generator().manual_seed(0))
    want = np.asarray(nn.initializers.lecun_normal()(jax.random.PRNGKey(0), flax_shape))
    scale = got[0].numel() ** -0.5
    assert abs(got.std().item() / scale - 1.0) <= 0.02
    assert abs(want.std() / scale - 1.0) <= 0.02
    assert got.abs().max().item() <= CUT * scale * (1 + 1e-5)
    assert abs(_kurtosis(got.numpy().ravel()) - _kurtosis(want.ravel())) <= 0.1
