"""The backward of the port's linear attention, in f32 (and f64) on the CPU.

``linear_attention_backward_reference`` (the plain version of the CUDA
backward kernel) against the JAX package's custom VJP ``_bwd`` of the
Pallas kernel and against ``jax.vjp`` of its plain ``ops.linear_attention``,
at a whole N and a ragged N, with d = 32 (the model's head width) and 8.
Tolerance: rtol 1e-5 / atol 1e-6 of f32 sums in another order; the
gradients are O(1e-3 .. 1). ``torch.autograd.gradcheck`` holds the
``autograd.Function`` on its plain (CPU) path against finite differences
in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu import ops as jax_ops
from lintransunet_tpu.ops import pallas_attention
from lintransunet_tpu_torch.ops import linear_attention as la
from torch_port_helpers import head_split, t

CASES = [(2, 4, 256, 32), (1, 3, 300, 32), (1, 2, 37, 8)]  # (B, H, N, d)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape", CASES)
def test_backward_matches_jax_bwd_and_vjp(shape):
    q, k, v, g = _inputs(shape, seed=shape[2])
    got = la.linear_attention_backward_reference(*map(t, (q, k, v, g)))
    want_bwd = pallas_attention._bwd(False, tuple(map(jnp.asarray, (q, k, v))),
                                     jnp.asarray(g))
    _, vjp = jax.vjp(jax_ops.linear_attention, *map(jnp.asarray, (q, k, v)))
    want_vjp = vjp(jnp.asarray(g))
    for mine, a, b in zip(got, want_bwd, want_vjp):
        assert mine.shape == shape and mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mine.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", CASES)
def test_backward_on_head_split_views_matches_jax(shape):
    """The plain backward takes the model's views (no copies) and still
    equals ``_bwd`` and ``jax.vjp``."""
    q, k, v, g = _inputs(shape, seed=shape[2] + 1)
    views = [head_split(x) for x in (q, k, v, g)]
    assert not views[0].is_contiguous() or shape[1] == 1
    got = la.linear_attention_backward_reference(*views)
    want_bwd = pallas_attention._bwd(False, tuple(map(jnp.asarray, (q, k, v))),
                                     jnp.asarray(g))
    _, vjp = jax.vjp(jax_ops.linear_attention, *map(jnp.asarray, (q, k, v)))
    want_vjp = vjp(jnp.asarray(g))
    for mine, a, b in zip(got, want_bwd, want_vjp):
        assert mine.shape == shape and mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(mine.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_backward_keeps_the_input_dtype():
    q, k, v, g = (x.astype(np.float32) for x in _inputs((1, 2, 16, 8)))
    got = la.linear_attention_backward_reference(*(t(x).bfloat16() for x in (q, k, v, g)))
    assert all(x.dtype == torch.bfloat16 for x in got)


@pytest.mark.parametrize("n", [1, 19])
def test_gradcheck_through_the_function(n):
    gen = torch.Generator().manual_seed(n)
    qkv = [torch.randn((1, 2, n, 4), generator=gen, dtype=torch.float64,
                       requires_grad=True) for _ in range(3)]
    assert torch.autograd.gradcheck(la.LinearAttentionFunction.apply, qkv)


def test_cpu_autograd_uses_the_plain_path_without_counting():
    q, k, v, g = (t(x) for x in _inputs((1, 2, 33, 32), seed=3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (la.linear_attention.launches, la.linear_attention_backward.launches)
    la.linear_attention(*leaves).backward(g)
    via_function = [x.clone().requires_grad_() for x in (q, k, v)]
    la.LinearAttentionFunction.apply(*via_function).backward(g)
    assert (la.linear_attention.launches, la.linear_attention_backward.launches) == before
    want = la.linear_attention_backward_reference(q, k, v, g)
    for a, b, w in zip(leaves, via_function, want):
        torch.testing.assert_close(a.grad, w, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b.grad, w, rtol=0, atol=0)
