"""PyTorch port vs the JAX package, op by op, in f32 on the CPU.

The same numpy inputs (made from a seeded generator) go through each JAX
function and its port counterpart; activations move between the JAX
package's (N, H, W, D, C) layout and the port's (N, C, H, W, D).
Tolerance: rtol 1e-4 / atol 1e-5 (f32, sums taken in a different order by
XLA and by PyTorch); bounding boxes are integer counts and match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu import ops as jops
from lintransunet_tpu.ops import pallas_attention as pa
from lintransunet_tpu_torch import ops as tops
from lintransunet_tpu_torch.compat import from_ncdhw, to_ncdhw
from lintransunet_tpu_torch.ops import attention as tattn
from lintransunet_tpu_torch.ops import linear_attention as tfused
from torch_port_helpers import head_split

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_windows_embedding_roundtrip(rng):
    x = _normal(rng, 2, 8, 6, 3, 2)
    emb = tops.windows_embedding(_t(to_ncdhw(x)))
    _close(from_ncdhw(emb), jops.windows_embedding(jnp.asarray(x)))
    y = _normal(rng, 2, 4, 3, 3, 8)
    _close(from_ncdhw(tops.windows_unembedding(_t(to_ncdhw(y)))),
           jops.windows_unembedding(jnp.asarray(y)))
    _close(tops.windows_unembedding(emb), to_ncdhw(x))


@pytest.mark.parametrize("stride,groups", [((1, 1, 1), 1), ((2, 1, 2), 1),
                                           ((1, 1, 1), 3)])
def test_conv3d_matches_jax(rng, stride, groups):
    x = _normal(rng, 2, 7, 6, 5, 3)
    kernel = _normal(rng, 3, 3, 3, 3 // groups, 6) * 0.3
    bias = _normal(rng, 6)
    want = jops.conv3d(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias),
                       stride=stride, padding=1, groups=groups)
    weight = _t(kernel.transpose(4, 3, 0, 1, 2))  # (k..., I, O) -> (O, I, k...)
    got = tops.conv3d(_t(to_ncdhw(x)), weight, _t(bias), stride, 1, groups)
    _close(from_ncdhw(got), want)


def test_instance_norm_and_leaky_relu(rng):
    # an offset mean makes the single-pass E[x^2] - E[x]^2 form matter
    x = _normal(rng, 2, 6, 5, 4, 3) * 2.0 + 3.0
    _close(from_ncdhw(tops.instance_norm(_t(to_ncdhw(x)))),
           jops.instance_norm(jnp.asarray(x)))
    _close(tops.leaky_relu(_t(x)), jops.leaky_relu(jnp.asarray(x)))


def test_min_max_indice_family(rng):
    hist = np.where(rng.random(40) > 0.7, rng.random(40), 0).astype(np.float32)
    for h in (hist, np.zeros(40, np.float32)):  # incl. the empty fallback
        got = tops.min_max_indice(_t(h))
        want = jops.min_max_indice(jnp.asarray(h))
        for g, w in zip(got, want):
            assert float(g) == float(w)
        got2 = tops.min_max_indice2(_t(h))
        want2 = jops.min_max_indice2(jnp.asarray(h))
        for g, w in zip(got2, want2):
            assert int(g) == int(w)
    batch = np.stack([hist, np.zeros_like(hist), hist[::-1].copy()])
    lo, hi, mid = tops.min_max_indice(_t(batch))
    for i in range(3):
        want = jops.min_max_indice(jnp.asarray(batch[i]))
        assert (float(lo[i]), float(hi[i]), float(mid[i])) == tuple(
            float(w) for w in want)


@pytest.mark.parametrize("min_roi", [(4, 3), (14, 10)])
def test_mask_boundary_matches_jax(rng, min_roi):
    mask = rng.random((3, 16, 12, 4)) > 0.85
    mask[1] = False  # an empty mask takes the centre fallback
    mask[2, :, :, :] = False
    mask[2, 5:9, 2:4, 1] = True
    got = tops.mask_boundary(_t(mask), *min_roi)
    want = jops.mask_boundary(jnp.asarray(mask), *min_roi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transfer_index_family(rng):
    x0 = np.array([3.0, 10.0, 0.0], np.float32)
    x1 = np.array([20.0, 14.0, 31.0], np.float32)
    for fn in ("transfer_index_pix", "transfer_back_index_pix"):
        got = getattr(tops, fn)(_t(x0), _t(x1), 31, 12, 14)
        want = getattr(jops, fn)(jnp.asarray(x0), jnp.asarray(x1), 31, 12, 14)
        _close(got, want)
    pix = rng.uniform(-2, 34, (3, 14)).astype(np.float32)
    _close(tops.bilinear_weights_pix(_t(pix), 32),
           jops.bilinear_weights_pix(jnp.asarray(pix), 32))


def test_separable_grid_sample(rng):
    x = _normal(rng, 2, 10, 8, 3, 4)
    wx = rng.random((2, 7, 10)).astype(np.float32)
    wy = rng.random((2, 5, 8)).astype(np.float32)
    got = tops.separable_grid_sample_2d(_t(to_ncdhw(x)), _t(wx), _t(wy))
    want = jops.separable_grid_sample_2d(jnp.asarray(x), jnp.asarray(wx),
                                         jnp.asarray(wy))
    _close(from_ncdhw(got), want)


@pytest.mark.parametrize("scale", [(2, 2, 1), (2, 2, 2), 2])
def test_resizes(rng, scale):
    x = _normal(rng, 1, 4, 3, 2, 3)
    _close(from_ncdhw(tops.resize_linear_align_corners(_t(to_ncdhw(x)), scale)),
           jops.resize_linear_align_corners(jnp.asarray(x), scale))
    _close(from_ncdhw(tops.resize_nearest(_t(to_ncdhw(x)), scale)),
           jops.resize_nearest(jnp.asarray(x), scale))


def _qkv(rng, b, h, n, d):
    return [_normal(rng, b, h, n, d) for _ in range(3)]


def test_plain_attention_matches_jax(rng):
    q, k, v = _qkv(rng, 2, 3, 50, 16)
    mask = rng.random((2, 1, 50, 1)) > 0.3
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _close(tattn.linear_attention(_t(q), _t(k), _t(v)),
           jops.linear_attention(jq, jk, jv))
    _close(tattn.linear_attention(_t(q), _t(k), _t(v), mask=_t(mask)),
           jops.linear_attention(jq, jk, jv, mask=jnp.asarray(mask)))
    _close(tattn.softmax_attention(_t(q), _t(k), _t(v), mask=_t(mask)),
           jops.softmax_attention(jq, jk, jv, mask=jnp.asarray(mask)))
    _close(tfused.linear_attention_reference(_t(q), _t(k), _t(v)),
           jops.linear_attention(jq, jk, jv))


@pytest.mark.parametrize("form", ["whole_n", "tiled"])
def test_kernel_semantics_match_pallas_interpret(rng, monkeypatch, form):
    """The CUDA kernel's plain version against the Pallas kernel itself, in
    both of its forms (the tiled one with small limits, as
    tests/test_pallas_attention.py does)."""
    n = 300
    if form == "tiled":
        monkeypatch.setattr(pa, "WHOLE_N_LIMIT", 512)
        monkeypatch.setattr(pa, "TILE_N", 256)
        n = 1000  # > limit: pads to 1024 = 4 tiles
    q, k, v = _qkv(rng, 1, 2, n, 32)
    want = pa.linear_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), True)
    _close(tfused.linear_attention_reference(_t(q), _t(k), _t(v)), want)
    _close(tfused.linear_attention(_t(q), _t(k), _t(v)), want)


@pytest.mark.parametrize("form", ["whole_n", "tiled"])
def test_kernel_semantics_on_head_split_views_match_pallas_interpret(rng, monkeypatch, form):
    """The plain version on the model's views (no copies) against the
    Pallas kernel in both forms."""
    n = 300
    if form == "tiled":
        monkeypatch.setattr(pa, "WHOLE_N_LIMIT", 512)
        monkeypatch.setattr(pa, "TILE_N", 256)
        n = 1000
    q, k, v = _qkv(rng, 2, 3, n, 32)
    want = pa.linear_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), True)
    views = [head_split(x) for x in (q, k, v)]
    assert all(tfused.layout_strides(x) == (n * 96, 32, 96) for x in views)
    _close(tfused.linear_attention_reference(*views), want)
    _close(tfused.linear_attention(*views), want)


def test_kernel_layouts_and_limits():
    """What the CUDA wrappers take, checked on CPU tensors: contiguous
    (B, H, N, d) and the head-split view, with d 2, 4 or a multiple of 8 up
    to 32, aligned to 16 bytes or to a narrower head row's own size;
    anything else raises before a launch."""
    b, h, n, d = 2, 3, 40, 16
    heads = torch.zeros((b, n, h * d)).view(b, n, h, d).transpose(1, 2)
    flat = torch.zeros((b, h, n, d))
    assert tfused.layout_strides(heads) == (n * h * d, d, h * d)
    assert tfused.layout_strides(flat) == (h * n * d, n * d, d)
    assert len(tfused._check_cuda_inputs(heads, flat, heads, flat)) == 12
    # size-1 dims take any stride
    one = torch.zeros((1, n, 1 * d)).view(1, n, 1, d).transpose(1, 2)
    assert tfused.layout_strides(one) == one.stride()[:3]
    rejected = [
        flat[:, :, ::2],                                     # every other token
        flat.transpose(2, 3).contiguous().transpose(2, 3),   # features not innermost
        torch.zeros((b, n, 2 * h, d))[:, :, :h].transpose(1, 2),  # a wider projection
        torch.zeros(flat.numel() + 1)[1:].view(b, h, n, d),  # not 16-byte aligned
    ]
    for x in rejected:
        assert tfused.layout_strides(x) is None
        with pytest.raises(ValueError):
            tfused._check_cuda_inputs(x, x, x)
    for width in (1, 6, 12, 20, 40, 64):
        x = torch.zeros((1, 2, 8, width))
        with pytest.raises(ValueError):
            tfused._check_cuda_inputs(x, x, x)
    # narrow heads: a bf16 row of d = 2 is 4 bytes, of d = 4 is 8
    for width, dtype, align in ((2, torch.bfloat16, 4), (4, torch.bfloat16, 8),
                                (2, torch.float32, 8), (4, torch.float32, 16)):
        x = torch.zeros((b, n, h * width), dtype=dtype).view(b, n, h, width).transpose(1, 2)
        assert tfused.row_alignment(x) == align
        assert len(tfused._check_cuda_inputs(x, x, x)) == 9
        shifted = torch.zeros(x.numel() + 8, dtype=dtype)[align // x.element_size():]
        if align < 16:  # off a 16-byte boundary by the row's size: taken
            assert tfused.layout_strides(shifted[:x.numel()].view(b, h, n, width)) is not None
        odd = torch.zeros(x.numel() + 1, dtype=dtype)[1:x.numel() + 1].view(b, h, n, width)
        assert tfused.layout_strides(odd) is None
    with pytest.raises(TypeError):
        tfused._check_cuda_inputs(flat.half(), flat.half(), flat.half())
    with pytest.raises(ValueError):
        tfused._check_cuda_inputs(flat, flat, flat, flat[:, :, :8])


def test_kernel_plan_is_built_once_per_signature(monkeypatch):
    """``lta_call``'s plan array, checked on CPU tensors with the library's
    scratch size stubbed: sizes and each tensor's strides, the outputs'
    their own (allocated in the layout of q by ``_empty_out``); one plan per
    signature, and a signature the kernels do not take raises before any
    plan is kept."""

    class Library:
        @staticmethod
        def lta_scratch_floats(bh, n, backward):
            return 7

    monkeypatch.setattr(tfused, "_library", Library)
    monkeypatch.setattr(tfused, "_plans", {})
    b, h, n, d = 2, 3, 40, 16
    heads = torch.zeros((b, n, h * d)).view(b, n, h, d).transpose(1, 2)
    flat = torch.zeros((b, h, n, d))
    split, contiguous = [n * h * d, d, h * d], [h * n * d, n * d, d]
    out = (tfused._empty_out(heads),)
    first = tfused._plan((heads, flat, heads), out)
    plan, bh, floats, align = first
    assert (bh, floats, align) == (b * h, 7, 16)
    assert list(plan) == [0, 0, b * h, h, n, d] + split + contiguous + split + split
    assert tfused._empty_out(heads).stride() == heads.stride()
    grads = tuple(tfused._empty_out(flat) for _ in range(3))
    plan, _, _, _ = tfused._plan((flat, heads, flat, heads.bfloat16().float()), grads)
    assert list(plan) == [1, 0, b * h, h, n, d] + contiguous + split + contiguous + split \
        + contiguous * 3
    assert len(tfused._plans) == 2
    # another tensor, one signature
    assert tfused._plan((heads.clone(), flat, heads), (tfused._empty_out(heads),)) is first
    with pytest.raises(ValueError):
        tfused._plan((heads, flat, flat[:, :, ::2]), out)
    assert len(tfused._plans) == 2


def test_kernel_plan_of_the_packed_qkv_layout(monkeypatch):
    """The thirds of a fused (B, N, 3*H*d) QKV projection (``split_qkv``):
    views, no copies, with head stride d, token stride 3*H*d and batch
    stride N*3*H*d; the forward's output is a new head-split (B, N, H*d)
    tensor whose strides the plan takes from the output itself (not from
    q, whose token stride is 3*H*d); the backward's gradients are the thirds
    of one new (B, N, 3*H*d) tensor, with its strides. Checked on CPU
    tensors with the library's scratch size stubbed."""

    class Library:
        @staticmethod
        def lta_scratch_floats(bh, n, backward):
            return 7

    monkeypatch.setattr(tfused, "_library", Library)
    monkeypatch.setattr(tfused, "_plans", {})
    b, h, n, d = 2, 3, 40, 16
    qkv = torch.arange(b * n * 3 * h * d, dtype=torch.float32).view(b, n, 3 * h * d)
    q, k, v = tfused.split_qkv(qkv, h)
    packed, split = [n * 3 * h * d, d, 3 * h * d], [n * h * d, d, h * d]
    for i, x in enumerate((q, k, v)):
        assert x.shape == (b, h, n, d) and x.data_ptr() == qkv.data_ptr() + 4 * i * h * d
        assert list(tfused.layout_strides(x)) == packed
        np.testing.assert_array_equal(
            x.numpy(), qkv.view(b, n, 3, h, d)[:, :, i].transpose(1, 2).numpy())
    out = tfused._empty_out(q)
    assert list(out.stride()) == split + [1]
    plan, bh, _, align = tfused._plan((q, k, v), (out,))
    assert (bh, align) == (b * h, 16)
    assert list(plan) == [0, 0, b * h, h, n, d] + packed * 3 + split
    grad = tfused._empty_out(q)
    d_qkv = torch.empty_like(qkv)
    plan, _, _, _ = tfused._plan((q, k, v, grad), tfused.split_qkv(d_qkv, h))
    assert list(plan) == [1, 0, b * h, h, n, d] + packed * 3 + split + packed * 3
    with pytest.raises(ValueError, match="does not split"):
        tfused.split_qkv(qkv[..., :-1], h)
    # a third of a (B, N, 2*H*d) tensor, or of a non-contiguous (B, N, 3*H*d) one
    for wrong in (torch.zeros((b, n, 2 * h * d)).view(b, n, 2, h, d)[:, :, 0].transpose(1, 2),
                  tfused.split_qkv(torch.zeros((b, 2 * n, 3 * h * d))[:, ::2], h)[0]):
        assert tfused.layout_strides(wrong) is None
