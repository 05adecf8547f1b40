"""The port's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU and ``nvcc``; skips without a card. On a machine with
the card and no jax (this file imports none), run it without the repo's
jax-configuring conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances, each a share of the plain output's largest magnitude:

* linear attention: f32 5e-5 (sums in another order); bf16 2e-2 (both
  round their f32 result to bf16 once, at places that can differ by one
  bf16 ulp).
* conv unit: y and z f32 1e-5, bf16 2e-2 (the same operands, rounded alike,
  summed in f32 in another order; bf16 outputs one ulp apart); statistics
  f32 1e-5, bf16 1e-3 (sums of outputs that can sit one bf16 ulp apart).
* transformer stack: f32 1e-5 (f32 through post-LN layers, sums in another
  order); bf16 3e-2 (the kernel rounds every product's operands to bf16, as
  the TPU kernel does; the plain version computes in f32 and rounds the
  tokens once a layer).
"""

import pytest
import torch

from lintransunet_tpu_torch.ops import conv_unit as cu
from lintransunet_tpu_torch.ops import fused_stack as fs
from lintransunet_tpu_torch.ops import linear_attention as fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 8, 4096, 32), (1, 4, 28704, 32),
                                   (2, 3, 300, 32), (1, 2, 1, 32),
                                   (1, 2, 129, 16)])
def test_kernel_matches_plain(cuda, shape, dtype, tol):
    q, k, v = _qkv(shape, dtype, cuda)
    before = fused.linear_attention.launches
    got = fused.linear_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused.linear_attention.launches == before + 1
    want = fused.linear_attention_reference(q, k, v)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 64, 32), torch.float32, cuda)
    with pytest.raises(TypeError):
        fused.linear_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fused.linear_attention(q[:, :, ::2], k[:, :, ::2], v[:, :, ::2])
    wide = _qkv((1, 1, 64, 64), torch.float32, cuda)
    with pytest.raises(ValueError):
        fused.linear_attention(*wide)
    with pytest.raises(NotImplementedError, match="B.3"):
        fused.linear_attention(q.requires_grad_(), k, v)


def _rel(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)


def _conv_inputs(n, ca, cb, o, spatial, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    w = (rnd(o, ca + cb, 3, 3, 3) / (27 * (ca + cb)) ** 0.5).to(device)
    kw = dict(bias=(rnd(o) * 0.1).to(device),
              affine_a=torch.stack([rnd(n, ca).abs() + 0.5, rnd(n, ca)], 1).to(device))
    if cb:
        kw.update(xb=rnd(n, cb, *spatial).to(device, dtype), wb=w[:, ca:])
    return rnd(n, ca, *spatial).to(device, dtype), w[:, :ca], kw


CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,ca,cb,o,spatial", [
    (1, 32, 32, 32, (128, 128, 64)),   # the level-1 UpBlock's conv2
    (1, 4, 0, 16, (256, 256, 64)),     # the input block
    (2, 5, 0, 7, (9, 7, 13)),          # ragged in every dim
    (1, 3, 6, 20, (6, 5, 70)),         # ragged, dual, two output tiles
])
def test_conv_unit_matches_plain(cuda, dtype, n, ca, cb, o, spatial):
    xa, wa, kw = _conv_inputs(n, ca, cb, o, spatial, dtype, cuda)
    before = cu.conv_unit.launches
    got = cu.conv_unit(xa, wa, want_z=True, **kw)
    torch.cuda.synchronize()
    assert cu.conv_unit.launches == before + 1
    want = cu.conv_unit_reference(xa, wa, want_z=True, **kw)
    y_tol, stats_tol = CONV_TOL[dtype]
    assert got[0].dtype == dtype and got[0].shape == (n, o) + spatial
    assert got[2].shape == xa.shape
    assert _rel(got[0], want[0]) <= y_tol
    assert _rel(got[1], want[1]) <= stats_tol
    assert _rel(got[2], want[2]) <= y_tol


def _stack_inputs(b, n, c, layers, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    A = rnd(layers, c, 6 * c) / c ** 0.5
    w2 = rnd(layers, 2 * c, c) / (2 * c) ** 0.5
    vecs = rnd(layers, 16, 2 * c) * 0.1
    vecs[:, 6] += 1.0   # LayerNorm scales near 1
    vecs[:, 8] += 1.0
    x = rnd(b, n, c).to(device, dtype)
    return x, A.to(device), w2.to(device), vecs.to(device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,n,c,layers", [
    (1, 5376, 256, 2),     # the level-2 ROI stack's width and tokens
    (1, 28704, 128, 1),    # the level-1 ROI stack
    (2, 300, 128, 2),      # ragged N, batch 2
    (1, 1, 64, 1),         # one token
])
def test_fused_stack_matches_plain(cuda, dtype, tol, b, n, c, layers):
    x, A, w2, vecs = _stack_inputs(b, n, c, layers, dtype, cuda)
    before = fs.fused_transformer_stack.launches
    got = fs.fused_transformer_stack(x, A, w2, vecs, c // 32)
    torch.cuda.synchronize()
    assert fs.fused_transformer_stack.launches == before + 1
    want = fs.fused_transformer_stack_reference(x, A, w2, vecs, c // 32)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, want) <= tol


def test_new_kernels_reject_what_they_do_not_take(cuda):
    xa, wa, kw = _conv_inputs(1, 4, 0, 8, (8, 8, 8), torch.float32, cuda)
    with pytest.raises(TypeError):
        cu.conv_unit(xa.half(), wa)
    with pytest.raises(ValueError):
        cu.conv_unit(xa.transpose(2, 3), wa)
    with pytest.raises(ValueError):
        cu.conv_unit(xa, wa, compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        cu.conv_unit(xa, wa.clone().requires_grad_())
    x, A, w2, vecs = _stack_inputs(1, 64, 128, 1, torch.float32, cuda)
    with pytest.raises(TypeError):
        fs.fused_transformer_stack(x.half(), A, w2, vecs, 4)
    with pytest.raises(ValueError):
        fs.fused_transformer_stack(x[:, ::2], A, w2, vecs, 4)
    with pytest.raises(ValueError):
        fs.fused_transformer_stack(x, A, w2, vecs, 2)  # d_k 64
    with pytest.raises(NotImplementedError):
        fs.fused_transformer_stack(x.requires_grad_(), A, w2, vecs, 4)
