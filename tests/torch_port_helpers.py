"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Parameters come from the flax tree's SHAPES (``jax.eval_shape`` of
``init``, no real init: the unjitted init of the 5-level model takes more
than a minute on the CPU) filled with seeded numpy normals; the same tree
goes to the JAX module and, through ``from_flax``, to the port.
"""

import jax
import numpy as np
import torch

from lintransunet_tpu_torch.compat import from_flax

SMALL = dict(
    num_layers=(8, 16, 32, 32, 64),
    roi_size_list=(16, 12, 8, 6, 4),
    is_roi_list=(False, True, True, True, True),
    dim_input=1,
    dim_output=2,
)


def random_params(module, *args, seed=0, scale=0.1, **kwargs):
    """numpy params tree of ``module.init(key, *args, **kwargs)``'s shapes."""
    shapes = jax.eval_shape(
        lambda key: module.init(key, *args, **kwargs), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
        shapes["params"])


def load_port(port_module, params):
    """Load the flax ``params`` into ``port_module`` (strict: every key and
    shape must match) and put it in eval mode."""
    port_module.load_state_dict(from_flax(params), strict=True)
    return port_module.eval()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def head_split(x):
    """(B, H, N, d) numpy -> the same values as the port's attention layers
    pass them: the head-split view ``view(B, N, H, d).transpose(1, 2)`` of a
    contiguous (B, N, H*d) tensor."""
    b, h, n, d = x.shape
    return t(x.transpose(0, 2, 1, 3).reshape(b, n, h * d)).view(b, n, h, d).transpose(1, 2)
