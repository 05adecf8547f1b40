"""The port's fused transformer stack (``ops/fused_stack.py``) against the
JAX package's, in f32 on the CPU.

* ``stack_layer_params`` read from the port's ``SelfAttentionLayer``
  modules equals JAX's from the same numpy parameter tree, exactly.
* The port's ``fused_transformer_stack`` (on a CPU tensor: its plain
  version) matches JAX ``fused_transformer_stack(..., interpret=True)`` and
  ``fused_stack_reference`` within rtol / atol 2e-5: f32 through L post-LN
  layers, each summing in another order (``tests/test_fused_stack.py`` holds
  JAX's kernel to its flax oracle at the same 2e-5).
* The port's ``EmbedAttention3DBlock`` and ``PosAttention3DBlock`` with the
  fused stack on equal their unfused selves within rtol / atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.models import SelfAttentionLayer as JaxSelfAttentionLayer
from lintransunet_tpu.ops import pallas_layer as pll
from lintransunet_tpu_torch import models as tm
from lintransunet_tpu_torch.ops import fused_stack as fs
from torch_port_helpers import load_port, random_params, t

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _layers(c, heads, n_layers, seed):
    """numpy flax trees of ``n_layers`` SelfAttentionLayers and their ports."""
    jmod = JaxSelfAttentionLayer(c, heads, 2 * c)
    trees = [random_params(jmod, np.zeros((1, 8, c), np.float32), seed=seed + i)
             for i in range(n_layers)]
    ports = [load_port(tm.SelfAttentionLayer(c, heads, 2 * c), p) for p in trees]
    return trees, ports


def test_stack_layer_params_match_jax():
    trees, ports = _layers(64, 2, 3, seed=1)
    want = pll.stack_layer_params(trees)
    got = fs.stack_layer_params(ports)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("c,heads,n_layers,n,b", [
    (128, 4, 2, 100, 2),   # ragged N (100 tokens in one 104-row tile)
    (256, 8, 1, 64, 1),    # the flagship's 256-wide stacks, one layer
    (128, 4, 1, 37, 1),
])
def test_fused_stack_matches_jax(c, heads, n_layers, n, b):
    trees, ports = _layers(c, heads, n_layers, seed=c + n)
    A, w2, vecs = fs.stack_layer_params(ports)
    x = np.random.default_rng(n).standard_normal((b, n, c)).astype(np.float32)
    before = fs.fused_transformer_stack.launches
    got = fs.fused_transformer_stack(t(x), A, w2, vecs, heads).numpy()
    assert fs.fused_transformer_stack.launches == before  # the plain version
    jA, jw2, jvecs = pll.stack_layer_params(trees)
    kernel = pll.fused_transformer_stack(jnp.asarray(x), jA, jw2, jvecs, heads,
                                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(kernel), **TOL)
    reference = pll.fused_stack_reference(jnp.asarray(x), jA, jw2, jvecs, heads)
    np.testing.assert_allclose(got, np.asarray(reference), **TOL)
    # and the unfused port layers give the same tokens
    want = t(x)
    for layer in ports:
        want = layer(want)
    np.testing.assert_allclose(got, want.detach().numpy(), **TOL)


@pytest.mark.parametrize("block", ["embed", "pos"])
def test_routed_blocks_equal_unfused(rng, block):
    if block == "embed":
        module = tm.EmbedAttention3DBlock(16, 64, 2, n_layers=3)
        x = rng.standard_normal((1, 16, 9, 6, 4)).astype(np.float32)
    else:
        module = tm.PosAttention3DBlock(64, 64, 2, n_layers=2)
        x = rng.standard_normal((2, 64, 4, 3, 2)).astype(np.float32)
    tm.init_random_(module, torch.Generator().manual_seed(3))
    module.eval()
    with torch.inference_mode():
        want = module(t(x))
        module.fused_stack = True
        got = module(t(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("is_bf16", [0, 1])
def test_scratch_shapes(is_bf16):
    """The CUDA kernel's scratch: per-tile partials of every feature, the
    combined ctx / s, and in bf16 each layer's A and w2 packed (8 C^2)."""
    shapes = fs.scratch_shapes(2, 128, 3, 5, is_bf16)
    want = {"part_m": ((2, 5, 128), torch.float32),
            "part_s": ((2, 5, 128), torch.float32),
            "part_ctx": ((2, 5, 128, fs.D_K), torch.float32),
            "ctxn": ((2, 128, fs.D_K), torch.float32)}
    if is_bf16:
        want["packed"] = ((3, 8 * 128 * 128), torch.bfloat16)
        assert 8 * 128 * 128 == 128 * 6 * 128 + 2 * 128 * 128  # A then w2
    assert shapes == want
