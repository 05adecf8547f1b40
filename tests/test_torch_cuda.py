"""The port's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU and ``nvcc``; skips without a card. On a machine with
the card and no jax (this file imports none), run it without the repo's
jax-configuring conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is held at the shapes the model's paths give it: the window's
and the training patch's attention calls at the serve and train batches,
the other models' head widths, the fused build's seven conv units and four
token stacks, the routed convolutions at both batches (the positional
encodings' forwards at every shape of the flagship's window and micro-step),
each probe at its
TPU probe's main shape through its entry point. The attention kernels are
also held on the model's layouts (the head-split view of a (B, N, H*d)
projection, the thirds of a fused QKV one), to two launches a call, to the
same bits on a second call, and to no copy in a
``MultiheadLinearAttention`` forward.

Tolerances, each a share of the plain output's largest magnitude:

* linear attention: f32 1e-5 of the plain version computed in f64 on the
  same inputs (sums in another order; at millions of tokens the f32 plain
  version's own summation error passes 1e-5); bf16 2e-2 (both round their
  f32 result to bf16 once, at places that can differ by one bf16 ulp). Its
  backward: dq, dk and dv each within the same of their own max |plain|; a
  gradient that is zero in exact arithmetic (dk of a single token, whose
  token softmax is 1; below 1e-3 of the largest of the three) is held
  against a tenth of the largest instead, the scale of the two sums that
  cancel in it.
* conv unit: y and z f32 1e-5, bf16 2e-2 (the same operands, rounded alike,
  summed in f32 in another order; bf16 outputs one ulp apart); statistics
  f32 1e-5, bf16 1e-3 (sums of outputs that can sit one bf16 ulp apart).
* transformer stack: f32 1e-5 (f32 through post-LN layers, sums in another
  order); bf16 3e-2 (the kernel rounds every product's operands to bf16, as
  the TPU kernel does; the plain version computes in f32 and rounds the
  tokens once a layer).
* narrow-output convolution (``ops.conv_narrow``): 2^-7 of the plain
  version's largest magnitude (the same bf16 operands, products summed in
  f32 in another order, each side rounding its sum to bf16 once: one bf16
  ulp is 2^-8 of a value); its gradients are cuDNN's own calls, equal to
  the bit under cuDNN's deterministic algorithms.
* depthwise weight gradient (``ops.conv_wgrad``): 1e-5 of the plain f32
  gradient's largest magnitude (both sum the same bf16 products in f32,
  over 240-9,216 voxels, in another order); its data and bias gradients
  through ``DepthwiseConv3d`` are cuDNN's own calls, equal to the bit.
* depthwise convolution (``ops.conv_depthwise``): 2^-7 of the plain
  version's largest magnitude (the same bf16 operands, 27 products summed
  in f32 in another order, each side rounding its sum to bf16 once: one
  bf16 ulp is 2^-8 of a value).
* probes (``lintransunet_tpu_torch/experiments``): bf16 2e-2 (the same bf16
  operands, products summed in f32 in another order, each side rounding
  its result to bf16 once); variant E's bf16 accumulation 3e-2 (a bf16
  rounding after every tap, where a one-ulp difference carries into the
  next sum); f32 convs 1e-5 (f32 FMA against cuDNN in f32 with TF32 off);
  lane sums 1e-5 of each sum's max |plain| (f32 sums in another order).
"""

import multiprocessing

import pytest
import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.experiments import (
    conv_prototype,
    conv_retired,
    dot_probe,
    in_stats_probe,
    inner_probe,
    rowoffset_probe,
)
from lintransunet_tpu_torch import kernels
from lintransunet_tpu_torch.kernels.launches import cuda_launches
from lintransunet_tpu_torch.ops import conv_depthwise as cd
from lintransunet_tpu_torch.ops import conv_narrow as cn
from lintransunet_tpu_torch.ops import conv_unit as cu
from lintransunet_tpu_torch.ops import conv_wgrad as cw
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


ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _exact(*tensors):
    """The inputs the attention kernels' plain versions run on: f32 ones in
    f64, so that the plain version sums exactly enough (at (8, 4,194,304,
    2) its f32 summation error is 6.4e-5 of max |out| against the f64
    answer, the kernel's 4.5e-6); bf16 ones as they are (the plain version
    computes in f32 and rounds once, as the kernel does)."""
    return [t.double() if t.dtype == torch.float32 else t for t in tensors]


def _two_launches_a_call(fn):
    """Two CUDA launches a call, counted at the host's launch calls over
    three calls, and no more device rows than launches. The rows bound
    passes with no rows recorded too: late in a long process the profiler
    keeps none (see ``_in_a_new_process``)."""
    found = cuda_launches(fn, 3)
    assert len(found.launches) == 6 and len(found.rows) <= 6, found


def _hold_backward(got, want, dtype, like):
    """dq, dk and dv in ``like``'s dtype, shape and layout, each within
    ATTN_TOL of its own max |plain| (or of a tenth of the largest, where it
    is zero in exact arithmetic)."""
    top = max(w.float().abs().max().item() for w in want)
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape and _same_layout(a, like)
        err = (a.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= ATTN_TOL[dtype] * (scale if scale >= 1e-3 * top else 1e-1 * top)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 4096, 32), (1, 4, 28704, 32),
                                   (2, 3, 300, 32), (1, 2, 1, 32),
                                   (1, 2, 129, 16),
                                   # the window's other two, a ragged and a one-token call
                                   (1, 8, 2160, 32), (1, 8, 5376, 32),
                                   (1, 8, 300, 32), (1, 8, 1, 32)])
def test_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda)
    before = fused.linear_attention.launches
    got = fused.linear_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused.linear_attention.launches == before + 1
    want = fused.linear_attention_reference(*_exact(q, k, v))
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got, want) <= ATTN_TOL[dtype]
    _two_launches_a_call(lambda: fused.linear_attention(q, k, v))


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 64, 32), torch.float32, cuda)
    with pytest.raises(TypeError):
        fused.linear_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fused.linear_attention(q[:, :, ::2], k[:, :, ::2], v[:, :, ::2])
    wide = _qkv((1, 1, 64, 64), torch.float32, cuda)
    with pytest.raises(ValueError):
        fused.linear_attention(*wide)
    with pytest.raises(ValueError):
        fused.linear_attention_backward(q, k, v, q[:, :, :32].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 2048, 32), (1, 4, 14352, 32),
                                   (2, 3, 300, 32), (1, 2, 1, 32),
                                   (1, 2, 129, 16),
                                   # the patch's other two, a ragged and a one-token call
                                   (1, 8, 1080, 32), (1, 8, 2688, 32),
                                   (1, 8, 300, 32), (1, 8, 1, 32)])
def test_backward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda)
    g = _qkv(shape, dtype, cuda, seed=1)[0]
    before = fused.linear_attention_backward.launches
    got = fused.linear_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    assert fused.linear_attention_backward.launches == before + 1
    _hold_backward(got, fused.linear_attention_backward_reference(*_exact(q, k, v, g)), dtype, q)
    _two_launches_a_call(lambda: fused.linear_attention_backward(q, k, v, g))


def test_autograd_launches_both_kernels(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv((1, 4, 777, 32), torch.float32, cuda))
    g = _qkv((1, 4, 777, 32), torch.float32, cuda, seed=1)[0]
    before = (fused.linear_attention.launches, fused.linear_attention_backward.launches)
    out = fused.linear_attention(q, k, v)
    out.backward(g.transpose(1, 2).contiguous().transpose(1, 2))  # a strided gradient
    assert (fused.linear_attention.launches,
            fused.linear_attention_backward.launches) == (before[0] + 1, before[1] + 1)
    want = fused.linear_attention_backward_reference(q.detach(), k.detach(), v.detach(), g)
    for t, w in zip((q, k, v), want):
        assert _rel(t.grad, w) <= ATTN_TOL[torch.float32]


def _rel(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)


def _heads(b, n, h, d, dtype, device, seed=0):
    """(B, H, N, d) as the model passes it: the head-split view of a
    contiguous (B, N, H*d) projection."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, n, h * d), generator=g).to(device, dtype)
    return x.view(b, n, h, d).transpose(1, 2)


def _same_layout(got, want):
    """Equal strides wherever the size is above 1."""
    return all(size == 1 or a == b for size, a, b in zip(want.shape, got.stride(), want.stride()))


def _hold_both_ways(q, k, v, g, dtype):
    """Forward and backward against the plain versions, out and the
    gradients in the layout of q, two launches a call each way."""
    got = fused.linear_attention(q, k, v)
    want = fused.linear_attention_reference(*_exact(q, k, v))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape and _same_layout(got, q)
    assert _rel(got, want) <= ATTN_TOL[dtype]
    got = fused.linear_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    _hold_backward(got, fused.linear_attention_backward_reference(*_exact(q, k, v, g)), dtype, q)
    _two_launches_a_call(lambda: fused.linear_attention(q, k, v))
    _two_launches_a_call(lambda: fused.linear_attention_backward(q, k, v, g))


# (H, N) of the window's four attention calls (bottleneck, levels 3, 2, 1)
# and of the training patch's, each held at batch 1 and at a batch the CLIs
# give it: a served volume's 2 windows in one forward, train3d's default
# --batch_size of 3
WINDOW_CALLS = [(8, 4096), (8, 2160), (8, 5376), (4, 28704)]
PATCH_CALLS = [(8, 2048), (8, 1080), (8, 2688), (4, 14352)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,d", [(1, 4096, 8, 32), (1, 28704, 4, 32), (2, 300, 3, 32),
                                     (1, 1, 2, 32)]
                         + [(b, n, h, 32) for b in (1, 2) for h, n in WINDOW_CALLS
                            if (b, n) not in ((1, 4096), (1, 28704))]
                         + [(b, n, h, 32) for b in (1, 3) for h, n in PATCH_CALLS])
def test_kernels_read_the_head_split_view(cuda, b, n, h, d, dtype):
    """Forward and backward on the model's layout against the plain
    versions; out and the gradients come out in the layout of q."""
    _hold_both_ways(*(_heads(b, n, h, d, dtype, cuda, seed) for seed in range(4)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,d,layout", [
    (1, 70001, 8, 2, "heads"), (1, 20000, 8, 4, "heads"), (2, 300, 3, 2, "heads"),
    (2, 300, 3, 4, "contiguous"), (1, 129, 2, 2, "contiguous"), (1, 1, 2, 4, "heads"),
    # SkipTransUnet's skip bridges on a 512 x 512 x 64 window (levels 0-3)
    (1, 4194304, 8, 2, "heads"), (1, 1048576, 8, 4, "heads"), (1, 131072, 8, 8, "heads"),
    (1, 32768, 8, 16, "heads"),
    # MaskSkipTransUnet's d = 16 calls (bottleneck, then ROI levels 3-0)
    (1, 4096, 16, 16, "heads"), (1, 32480, 8, 16, "heads"), (1, 22272, 4, 16, "heads"),
    (1, 27968, 2, 16, "heads"), (1, 15776, 1, 16, "heads")])
def test_narrow_heads_match_plain(cuda, b, n, h, d, layout, dtype):
    """The head widths under 32 that the other models of ``Model_Dict`` run
    (d = 2 and 4: heads of 4 or 8 bytes in bf16), forward and backward
    against the plain versions, two launches a call, outputs in the layout
    of q."""
    if layout == "heads":
        q, k, v, g = (_heads(b, n, h, d, dtype, cuda, seed) for seed in range(4))
    else:
        q, k, v = _qkv((b, h, n, d), dtype, cuda)
        g = _qkv((b, h, n, d), dtype, cuda, seed=1)[0]
    _hold_both_ways(q, k, v, g, dtype)


def test_narrow_heads_need_their_row_alignment_only(cuda):
    """A d = 2 bf16 head row is 4 bytes: a tensor 4 bytes off a 16-byte
    boundary is taken, one 2 bytes off raises."""
    n, h, d = 300, 3, 2
    base = torch.randn(n * h * d + 2, generator=torch.Generator().manual_seed(0)).to(
        cuda, torch.bfloat16)
    q = base[2:].view(1, h, n, d)
    assert q.data_ptr() % 16 and q.data_ptr() % 4 == 0
    _rel_ok = _rel(fused.linear_attention(q, q, q), fused.linear_attention_reference(q, q, q))
    assert _rel_ok <= 2e-2
    odd = base[1:-1].view(1, h, n, d)
    with pytest.raises(ValueError):
        fused.linear_attention(odd, odd, odd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_calls_are_equal_to_the_bit(cuda, dtype):
    q, k, v, g = (_heads(1, 28704, 4, 32, dtype, cuda, seed) for seed in range(4))
    assert torch.equal(fused.linear_attention(q, k, v), fused.linear_attention(q, k, v))
    first = fused.linear_attention_backward(q, k, v, g)
    second = fused.linear_attention_backward(q, k, v, g)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("n", [1, 4096, 28704])
def test_each_call_is_at_most_two_launches(cuda, n):
    """Two CUDA launches a call, forward and backward, counted at the
    host's launch calls over three calls."""
    q, k, v, g = (_heads(1, n, 4, 32, torch.bfloat16, cuda, seed) for seed in range(4))
    fused.linear_attention_backward(q, k, v, g)  # built and loaded
    _two_launches_a_call(lambda: fused.linear_attention(q, k, v))
    _two_launches_a_call(lambda: fused.linear_attention_backward(q, k, v, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_module_copies_nothing(cuda, dtype):
    """One MultiheadLinearAttention forward launches what its fused QKV
    product (with the two concatenations of its weights and biases) and its
    output projection launch alone and the kernel's two launches, and runs
    no copy; and the kernel build agrees with the plain one."""
    from lintransunet_tpu_torch.models.blocks import MultiheadLinearAttention

    module = MultiheadLinearAttention(256, 8).to(cuda, dtype)
    x = torch.randn((1, 4096, 256), generator=torch.Generator().manual_seed(0)).to(cuda, dtype)
    qkv = [getattr(module, f"linears_{i}") for i in range(3)]

    def projections():
        packed = F.linear(x, torch.cat([p.weight for p in qkv]), torch.cat([p.bias for p in qkv]))
        return packed, module.linears_3(x)

    with torch.no_grad():
        got = module(x)
        alone = cuda_launches(projections)
        before = fused.linear_attention.launches
        found = cuda_launches(lambda: module(x))
        calls = fused.linear_attention.launches - before
        module.attention_impl = "plain"
        want = module(x)
    assert calls == 1
    assert len(found.launches) == len(alone.launches) + 2, (found.launches, alone.launches)
    assert not [op for op in found.ops if "copy" in op or "clone" in op], found.ops
    assert _rel(got, want) <= (5e-5 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,h,d", [(1, 4096, 8, 32), (2, 300, 3, 32), (1, 1, 2, 32),
                                     (1, 20000, 8, 4), (2, 129, 2, 2)]
                         + [(1, n, h, 32) for h, n in WINDOW_CALLS[1:] + PATCH_CALLS])
def test_kernels_read_the_packed_qkv_layout(cuda, b, n, h, d, dtype):
    """The thirds of a fused (B, N, 3*H*d) QKV projection, forward and
    backward through ``linear_attention_qkv`` against the plain versions on
    the same views: two launches a call each way, no copy, the output the
    head-split view of a new (B, N, H*d) tensor and the gradient one
    contiguous (B, N, 3*H*d) tensor; the backward writes into the thirds of
    a buffer it is given."""
    g = torch.Generator().manual_seed(n)
    qkv = torch.randn((b, n, 3 * h * d), generator=g).to(cuda, dtype).requires_grad_(True)
    grad = _heads(b, n, h, d, dtype, cuda, seed=1)
    got = fused.linear_attention_qkv(qkv, h)
    q, k, v = fused.split_qkv(qkv.detach(), h)
    want = fused.linear_attention_reference(*_exact(q, k, v))
    assert got.dtype == dtype and got.shape == (b, h, n, d)
    assert _same_layout(got, _heads(b, n, h, d, dtype, cuda))
    assert _rel(got, want) <= ATTN_TOL[dtype]
    got.backward(grad)
    want_grads = fused.linear_attention_backward_reference(*_exact(q, k, v, grad))
    d_qkv = qkv.grad
    assert d_qkv.shape == qkv.shape and d_qkv.is_contiguous()
    _hold_backward(fused.split_qkv(d_qkv, h), want_grads, dtype, q)
    thirds = fused.split_qkv(torch.empty_like(qkv), h)
    written = fused.linear_attention_backward(q, k, v, grad, out=thirds)
    assert [t.data_ptr() for t in written] == [t.data_ptr() for t in thirds]
    with torch.no_grad():
        forward = cuda_launches(lambda: fused.linear_attention_qkv(qkv, h), 3)
    backward = cuda_launches(lambda: fused.linear_attention_backward(
        q, k, v, grad, out=thirds), 3)
    for found in (forward, backward):
        assert len(found.launches) == 6 and len(found.rows) <= 6, found
    assert not [op for op in forward.ops + backward.ops if "copy" in op or "clone" in op]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_qkv_attention_module(cuda, dtype):
    """A MultiheadLinearAttention forward is two products (the fused QKV
    one and the output projection) and one kernel call, with no copy; it
    agrees with three projections and the kernel on their head-split
    views (JAX's default path)."""
    from lintransunet_tpu_torch.models.blocks import MultiheadLinearAttention

    module = MultiheadLinearAttention(256, 8).to(cuda, dtype)
    x = torch.randn((1, 4096, 256), generator=torch.Generator().manual_seed(0)).to(cuda, dtype)
    with torch.no_grad():
        q, k, v = (getattr(module, f"linears_{i}")(x).view(1, -1, 8, 32).transpose(1, 2)
                   for i in range(3))
        want = module.linears_3(fused.linear_attention(q, k, v).transpose(1, 2).reshape(1, -1, 256))
        got = module(x)
        before = fused.linear_attention.launches
        found = cuda_launches(lambda: module(x))
        calls = fused.linear_attention.launches - before
    assert calls == 1
    assert found.ops.count("aten::linear") == 2, found.ops
    assert not [op for op in found.ops if "copy" in op or "clone" in op], found.ops
    assert _rel(got, want) <= (5e-5 if dtype == torch.float32 else 2e-2)


def test_kernel_rejects_other_layouts(cuda):
    q, k, v = _qkv((1, 2, 64, 32), torch.float32, cuda)
    with pytest.raises(ValueError):  # features not innermost
        fused.linear_attention(*(t.transpose(1, 3).contiguous().transpose(1, 3) for t in (q, k, v)))
    with pytest.raises(ValueError):  # heads of a wider projection (token stride 128, not 64)
        wide = torch.randn((1, 64, 4, 32), device=cuda)[:, :, :2].transpose(1, 2)
        fused.linear_attention(wide, wide, wide)
    with pytest.raises(ValueError):  # not 16-byte aligned
        odd = torch.randn(2 * 64 * 32 + 1, device=cuda)[1:].view(1, 2, 64, 32)
        fused.linear_attention(odd, odd, odd)
    with pytest.raises(ValueError):  # a gradient in another layout
        fused.linear_attention_backward(q, k, v, q.transpose(1, 3).contiguous().transpose(1, 3))
    for d in (1, 6, 12, 20):
        narrow = _qkv((1, 2, 64, d), torch.bfloat16, cuda)
        with pytest.raises(ValueError):
            fused.linear_attention(*narrow)
        with pytest.raises(ValueError):
            fused.linear_attention_backward(*narrow, narrow[0])


def _conv_inputs(n, ca, cb, o, spatial, dtype, device, seed=0, affine=True):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    w = (rnd(o, ca + cb, 3, 3, 3) / (27 * (ca + cb)) ** 0.5).to(device)
    kw = dict(bias=(rnd(o) * 0.1).to(device))
    if affine:
        kw["affine_a"] = torch.stack([rnd(n, ca).abs() + 0.5, rnd(n, ca)], 1).to(device)
    if cb:
        kw.update(xb=rnd(n, cb, *spatial).to(device, dtype), wb=w[:, ca:])
    return rnd(n, ca, *spatial).to(device, dtype), w[:, :ca], kw


CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-3)}
# (N, Ca, Cb, O, (H, W, D), the prologue affine on xa) of the seven units of
# a 512 x 512 x 64 window in the fused build, each called as the model calls
# it: the affine on the UpBlocks' conv2, no z
WINDOW_UNITS = [
    (1, 4, 0, 16, (256, 256, 64), False),    # the encoder's input block
    (1, 16, 0, 16, (256, 256, 64), False),   # encoder block 0 conv1
    (1, 32, 0, 32, (128, 128, 64), False),   # encoder block 1 conv1
    (1, 64, 0, 32, (128, 128, 64), False),   # decoder level 1 conv1
    (1, 32, 32, 32, (128, 128, 64), True),   # decoder level 1 conv2
    (1, 32, 0, 16, (256, 256, 64), False),   # decoder level 0 conv1
    (1, 16, 16, 16, (256, 256, 64), True),   # decoder level 0 conv2
]


def _check_conv_unit(device, dtype, compute, n, ca, cb, o, spatial, affine, want_z):
    """y, the statistics and (``want_z``) z against the plain version, at
    ``dtype``'s tolerances (the f32 ones for f32 activations, whatever the
    operands), one launch a call."""
    xa, wa, kw = _conv_inputs(n, ca, cb, o, spatial, dtype, device, affine=affine)
    kw["compute_dtype"] = compute
    before = cu.conv_unit.launches
    got = cu.conv_unit(xa, wa, want_z=want_z, **kw)
    torch.cuda.synchronize()
    assert cu.conv_unit.launches == before + 1
    want = cu.conv_unit_reference(xa, wa, want_z=want_z, **kw)
    y_tol, stats_tol = CONV_TOL[dtype]
    assert got[0].dtype == dtype and got[0].shape == (n, o) + spatial
    assert _rel(got[0], want[0]) <= y_tol
    assert _rel(got[1], want[1]) <= stats_tol
    if want_z:
        assert got[2].shape == xa.shape
        assert _rel(got[2], want[2]) <= y_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,ca,cb,o,spatial,affine,want_z", [
    (1, 32, 32, 32, (128, 128, 64), True, True),   # the level-1 UpBlock's conv2
    (1, 4, 0, 16, (256, 256, 64), True, True),     # the input block
    (2, 5, 0, 7, (9, 7, 13), True, True),          # ragged in every dim
    (1, 3, 6, 20, (6, 5, 70), True, True),         # ragged, dual, two output tiles
    (2, 20, 0, 16, (17, 11, 70), True, True),      # ragged in every dim of the 4 x 4 x 32 tile
    (1, 16, 16, 16, (256, 256, 64), True, True),   # the level-0 UpBlock's conv2: dual, NT = 16
    (1, 64, 0, 32, (128, 128, 64), True, True),    # the level-1 UpBlock's conv1
    (1, 8, 8, 24, (9, 10, 1), True, True),         # D = 1
    (1, 40, 0, 40, (8, 6, 16), True, True),        # two output tiles of 32 channels
    (1, 160, 160, 32, (6, 7, 40), True, True),     # weights too large to stay in shared memory
] + [unit + (False,) for unit in WINDOW_UNITS])
def test_conv_unit_matches_plain(cuda, dtype, n, ca, cb, o, spatial, affine, want_z):
    _check_conv_unit(cuda, dtype, dtype, n, ca, cb, o, spatial, affine, want_z)


@pytest.mark.parametrize("n,ca,cb,o,spatial,affine,want_z", [
    (1, 32, 32, 32, (128, 128, 64), True, True),
    (2, 5, 0, 7, (9, 7, 13), True, True),
    (2, 20, 0, 16, (17, 11, 70), True, True),
    (1, 8, 8, 24, (9, 10, 1), True, True),
] + [unit + (False,) for unit in WINDOW_UNITS])
def test_conv_unit_f32_input_bf16_operands(cuda, n, ca, cb, o, spatial, affine, want_z):
    """The default: f32 activations, operands rounded to bf16 when staged,
    y and z in f32; held to the f32 tolerance against the plain version,
    which rounds the same operands."""
    _check_conv_unit(cuda, torch.float32, None, n, ca, cb, o, spatial, affine, want_z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_unit_is_deterministic(cuda, dtype):
    """Two calls give the same bits: y, z and the statistics (per-block
    partials of a persistent grid, added in a fixed order, no atomics)."""
    xa, wa, kw = _conv_inputs(1, 16, 16, 16, (64, 64, 64), dtype, cuda)
    first = cu.conv_unit(xa, wa, want_z=True, **kw)
    second = cu.conv_unit(xa, wa, want_z=True, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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
    (1, 2160, 256, 7),     # the level-3 stack: fewer tiles than SMs
    (1, 4096, 256, 1),     # the bottleneck stack
    (2, 300, 256, 1),      # batch 2 at the 256-wide stacks
    (1, 200, 32, 2),       # the narrow widths
    (1, 200, 64, 2),
    # the window's four token stacks at 1 and 7 layers, those not above
    (1, 4096, 256, 7), (1, 2160, 256, 1), (1, 5376, 256, 1), (1, 5376, 256, 7),
    (1, 28704, 128, 7),
])
def test_fused_stack_matches_plain(cuda, dtype, tol, b, n, c, layers):
    _check_stack(cuda, dtype, tol, b, n, c, layers)


def _check_stack(device, dtype, tol, b, n, c, layers):
    x, A, w2, vecs = _stack_inputs(b, n, c, layers, dtype, device)
    before = fs.fused_transformer_stack.launches
    got = fs.fused_transformer_stack(x, A, w2, vecs, c // 32)
    torch.cuda.synchronize()
    assert fs.fused_transformer_stack.launches == before + 1
    want = fs.fused_transformer_stack_reference(x, A, w2, vecs, c // 32)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype,tol,tile", [(torch.float32, 1e-5, 16),
                                            (torch.bfloat16, 3e-2, 32)])
@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("where", ["one_token_more", "one_token_less_than_two"])
def test_fused_stack_ragged_tiles(cuda, dtype, tol, tile, c, where):
    """N one token past a tile, and one short of two tiles, for each tile
    the kernels take: f32 blocks hold 16 tokens, bf16 blocks 32."""
    from lintransunet_tpu_torch import kernels

    n = tile + 1 if where == "one_token_more" else 2 * tile - 1
    is_bf16 = int(dtype == torch.bfloat16)
    assert kernels.load("fused_stack").fst_num_tiles(n, is_bf16) == (n + tile - 1) // tile
    _check_stack(cuda, dtype, tol, 1, n, c, 2)


def test_fused_stack_is_deterministic(cuda):
    x, A, w2, vecs = _stack_inputs(1, 5376, 256, 2, torch.bfloat16, cuda)
    first = fs.fused_transformer_stack(x, A, w2, vecs, 8)
    second = fs.fused_transformer_stack(x, A, w2, vecs, 8)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_new_kernels_reject_what_they_do_not_take(cuda):
    xa, wa, kw = _conv_inputs(1, 4, 0, 8, (8, 8, 8), torch.float32, cuda)
    with pytest.raises(TypeError):
        cu.conv_unit(xa.half(), wa)
    with pytest.raises(ValueError):
        cu.conv_unit(xa.transpose(2, 3), wa)
    with pytest.raises(ValueError):
        cu.conv_unit(xa, wa, compute_dtype=torch.float16)
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


def test_small_train_step_kernel_matches_plain(cuda):
    """One train step of a small MaskTransUnet in f32 (TF32 off), kernel vs
    plain attention: 8 forward and 8 backward kernel calls (4 bridges of 2
    layers) twice, since the step's first call runs one eager forward and
    backward and then captures the micro-step as a CUDA graph (the replay
    calls no wrapper); the loss within 1e-5 relative and the gradients
    within 1e-3 of their max |plain| (a gradient that vanishes in exact
    arithmetic is held against a tenth of the largest, as in
    ``chip_smoke.py``)."""
    from lintransunet_tpu_torch import engine
    from lintransunet_tpu_torch.cli.common import get_criterion_list
    from lintransunet_tpu_torch.models import MaskTransUnet, init_random_

    small = dict(num_layers=(8, 16, 32, 32, 64), roi_size_list=(16, 12, 8, 6, 4),
                 is_roi_list=(False, True, True, True, True), dim_input=1,
                 dim_output=2, n_layers=2, dropout=0.3)
    g = torch.Generator(device="cpu").manual_seed(0)
    images = torch.randn((1, 1, 64, 64, 8), generator=g).to(cuda)
    labels = torch.zeros((1, 64, 64, 8), dtype=torch.long, device=cuda)
    labels[:, 20:44, 24:40, 2:6] = 1
    criterions, _ = get_criterion_list(5, ["CrossEntroLoss", "DiceClassLoss"])
    results = {}
    for impl in ("kernel", "plain"):
        model = MaskTransUnet(**small, attention_impl=impl, device=cuda)
        init_random_(model, torch.Generator(device="cpu").manual_seed(1))
        state = engine.create_train_state(model, 1e-4)
        before = (fused.linear_attention.launches, fused.linear_attention_backward.launches)
        loss, _ = engine.make_train_step(model, criterions)(
            state, images, labels, [0.1, 0.2, 0.3, 0.4, 1.0],
            torch.Generator(device=cuda).manual_seed(2))
        launched = (fused.linear_attention.launches - before[0],
                    fused.linear_attention_backward.launches - before[1])
        results[impl] = (loss.item(), {n: p.grad for n, p in model.named_parameters()},
                         launched)
    assert results["kernel"][2] == (16, 16) and results["plain"][2] == (0, 0)
    (loss, grads, _), (want_loss, want, _) = results["kernel"], results["plain"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        scale = w.abs().max().item()
        scale = scale if scale >= 1e-5 * top else 1e-1 * top
        assert (grads[name] - w).abs().max().item() <= 1e-3 * scale, name


PROBE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _probe_taps(groups, rows, k, taps, n, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((groups, rows, k), generator=g).to(device, torch.bfloat16)
    w = (torch.randn((taps, k, n), generator=g) * 0.05).to(device, torch.bfloat16)
    return x, w


# Offset lists of the tap-sum card tests, by name, for ``taps`` taps.
TAP_OFFSETS = {
    "zero": lambda taps: [0] * taps,
    "k576": lambda taps: [k * 576 for k in range(3)] * (taps // 3),       # 3 distinct
    "k577": lambda taps: [k * 577 for k in range(3)] * (taps // 3),
    "distinct": lambda taps: [5 * t + t % 3 for t in range(taps)],
    "negative": lambda taps: [-37 * t - 1 for t in range(taps)],           # rows before 0
    "past_r": lambda taps: [0] * (taps - 1) + [4000],                       # a tap wholly past R
}


# (groups, rows of x, output rows m) of the tap-sum cases: 3 groups of 4173
# rows and a ragged m (4123 = 32 x 128 + 27); the TPU probe's x, m all its
# rows (as the entry point's default)
TAP_RAGGED = (3, 4096 + 77, 4096 + 27)
TAP_MAIN = (dot_probe.GROUPS, dot_probe.M, dot_probe.M)


@pytest.mark.parametrize("taps,k,n,offsets,acc,shape", [case + (TAP_RAGGED,) for case in [
    (9, 128, 64, "zero", torch.float32),        # variant A: one distinct offset, hi and lo
    (9, 128, 64, "zero", torch.bfloat16),       # variant E: the whole of K in one item
    (1, 1152, 64, "zero", torch.float32),       # variant C: a lone tap, 18 K chunks resident
    (27, 128, 128, "zero", torch.float32),      # variant F
    (9, 128, 64, "k576", torch.float32),
    (9, 128, 64, "k577", torch.float32),        # #8 C
    (9, 128, 64, "k577", torch.bfloat16),       # bf16 accumulation, one run a tap
    (9, 128, 32, "distinct", torch.float32),
    (9, 128, 128, "negative", torch.float32),
    (9, 128, 64, "past_r", torch.float32),      # the window kernel refused it (too large)
    (9, 16, 16, "past_r", torch.float32),
    (9, 1152, 64, "k577", torch.float32),       # weights folded per item (too large to keep)
    (9, 1152, 64, "zero", torch.bfloat16),      # bf16 accumulation by (tap, K chunk)
    (27, 16, 16, "zero", torch.float32),        # the conv unit's smallest taps
    (1, 27 * 32, 32, "zero", torch.float32),    # tap-folded K = 27 C_in
]] + [(9, 128, 64, "zero", torch.float32, TAP_MAIN),     # #10 A at its main shape
      (9, 128, 64, "zero", torch.bfloat16, TAP_MAIN)])   # #10 E
def test_tap_sum_matches_plain(cuda, taps, k, n, offsets, acc, shape):
    """``taps_fold``, one launch a call; bf16 accumulation also nearer the
    bf16-accumulated sum than the f32 one."""
    groups, rows, m = shape
    x, w = _probe_taps(groups, rows, k, taps, n, cuda)
    offs = TAP_OFFSETS[offsets](taps)
    before = dot_probe.tap_sum.launches
    got = dot_probe.tap_sum(x, w, offs, m, acc_dtype=acc)
    torch.cuda.synchronize()
    assert dot_probe.tap_sum.launches == before + 1
    want = dot_probe.tap_sum_reference(x, w, offs, m, acc_dtype=acc)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (groups, m, n)
    assert _rel(got, want) <= (1e-2 if acc == torch.bfloat16 else 2e-2)
    assert _rel(got[:, -27:], want[:, -27:]) <= (1e-2 if acc == torch.bfloat16 else 2e-2)
    if acc == torch.bfloat16:  # nearer the bf16-accumulated sum than the f32 one
        f32_acc = dot_probe.tap_sum_reference(x, w, offs, m)
        assert dot_probe.bf16_rounding_share(got, want, f32_acc) <= dot_probe.E_ROUNDING_SHARE


def test_tap_sum_is_the_fold_then_the_products(cuda):
    """One call counts one launch of the probe and makes two CUDA launches:
    the fold, then ``taps_fold`` under programmatic dependent launch."""
    x, w = _probe_taps(2, 1000, 128, 9, 64, cuda)
    offsets = TAP_OFFSETS["k577"](9)
    dot_probe.tap_sum(x, w, offsets, 400)
    before = dot_probe.tap_sum.launches
    assert len(cuda_launches(lambda: dot_probe.tap_sum(x, w, offsets, 400)).launches) == 2
    assert dot_probe.tap_sum.launches == before + 1


def _unswizzled_fold(plan, k, n, device):
    """The fold launch's scratch as (products, k, n) bf16: tile (column tile,
    K chunk, product) holds NT rows (output columns) of 64 K values, 16-byte
    piece c of row r at piece c ^ (r % 8) (``ltu::swz``)."""
    stream = torch.cuda.current_stream(device).cuda_stream
    folded = dot_probe._FOLDED[(device.index, stream)][:plan.folded]
    nt, np_ = plan.nt, len(plan.products)
    nkc = -(-k // dot_probe.K_TILE)
    tiles = folded.view(n // nt, nkc, np_, nt, 8, 8)
    rows = torch.arange(nt, device=device)[:, None]
    piece = torch.arange(8, device=device)[None, :] ^ (rows % 8)
    tiles = tiles[:, :, :, rows, piece].reshape(n // nt, nkc, np_, nt, dot_probe.K_TILE)
    full = tiles.permute(2, 1, 4, 0, 3).reshape(np_, nkc * dot_probe.K_TILE, n)
    return full[:, :k], full[:, k:]


@pytest.mark.parametrize("taps,k,n,offsets,acc", [
    (9, 128, 64, "zero", torch.float32),        # #10 A: one hi and lo pair
    (9, 128, 64, "k577", torch.float32),        # #8 C: three pairs
    (9, 16, 16, "past_r", torch.float32),       # a pair and a lone tap; K padded to 64
    (9, 128, 128, "negative", torch.float32),   # all lone taps
    (9, 1152, 64, "k577", torch.float32),       # the streamed plan's fold
    (9, 128, 64, "zero", torch.bfloat16),       # bf16 accumulation: each tap as it is
])
def test_tap_sum_fold_is_the_reference_fold(cuda, taps, k, n, offsets, acc):
    """The fold launch writes exactly ``fold_taps_reference``'s hi and lo
    (the same f32 sums in the same order, rounded alike), zeros past K. A
    fold that dropped lo would pass the output tolerance; this does not."""
    x, w = _probe_taps(1, 600, k, taps, n, cuda)
    offs = TAP_OFFSETS[offsets](taps)
    dot_probe.tap_sum(x, w, offs, 500, acc_dtype=acc)
    torch.cuda.synchronize()
    plan = dot_probe.tap_plan(k, n, tuple(offs), acc == torch.bfloat16)
    got, padding = _unswizzled_fold(plan, k, n, x.device)
    distinct, hi, lo = dot_probe.fold_taps_reference(w, offs)
    for p, (d, part, tap_list) in enumerate(plan.products):
        if acc == torch.bfloat16:
            want = w[tap_list[0]]
        else:
            want = (lo if part == dot_probe.LO else hi)[distinct.index(plan.offsets[d])]
        assert torch.equal(got[p], want), (p, part)
    assert not padding.any()


@pytest.mark.parametrize("groups", [2, rowoffset_probe.GROUPS])
@pytest.mark.parametrize("variant", sorted(rowoffset_probe.OFFSETS))
def test_row_offset_sum_matches_plain(cuda, variant, groups):
    x, w = rowoffset_probe.inputs(groups, rowoffset_probe.M_PAD, cuda)
    offsets = rowoffset_probe.OFFSETS[variant]
    before = rowoffset_probe.row_offset_sum.launches
    got = rowoffset_probe.row_offset_sum(x, w, offsets)
    torch.cuda.synchronize()
    assert rowoffset_probe.row_offset_sum.launches == before + 1
    want = rowoffset_probe.row_offset_sum_reference(x, w, offsets)
    assert got.shape == (groups, rowoffset_probe.M, rowoffset_probe.N)
    assert _rel(got, want) <= PROBE_TOL[torch.bfloat16]
    lib = rowoffset_probe.library_call(x, w, offsets)()
    assert _rel(lib, want) <= PROBE_TOL[torch.bfloat16]


@pytest.mark.parametrize("strategy", inner_probe.STRATEGIES)
@pytest.mark.parametrize("batch,hbo", [(3, 12), (1, 2), (1, 1), (5, 3), (200, 1),
                                       (inner_probe.BATCH, inner_probe.HBO)])
def test_inner_step_matches_plain(cuda, strategy, batch, hbo):
    """Every strategy, through the entry point, is held to the dots27
    function on all rows, the two clipped edge rows included. The last
    192-row tile of a window is ragged (hbo * 136 rows: 1,632, 272, 136,
    408), some of its warpgroups wholly past the rows (one at hbo 12, two
    at hbo 1); 200 windows of one short tile each make more tiles than SMs;
    the TPU probe's 64 windows at hbo 12 last."""
    z, kp, ku, kd = inner_probe.inputs(batch, hbo, cuda)
    before = inner_probe.inner_step_packed.launches
    got = inner_probe.inner_step(z, kp, ku, kd, hbo, strategy)
    torch.cuda.synchronize()
    assert inner_probe.inner_step_packed.launches == before + 1
    want = inner_probe.inner_step_reference(z, kp, ku, kd, hbo)
    assert got.shape == (batch, hbo * inner_probe.WC, inner_probe.NO)
    assert _rel(got, want) <= PROBE_TOL[torch.bfloat16]
    assert _rel(got[:, [0, -1]], want[:, [0, -1]]) <= PROBE_TOL[torch.bfloat16]


@pytest.mark.parametrize("strategy", inner_probe.STRATEGIES)
def test_inner_weights_packed_on_the_card_are_the_cpu_packing(cuda, strategy):
    """The wrapper's packing on the card (one gather) is bit for bit the
    CPU's, and each tile, unswizzled, is its tap's weights."""
    z, kp, ku, kd = inner_probe.inputs(1, 1, cuda)
    got = inner_probe.pack_inner_weights(kp, ku, kd, strategy)
    want = inner_probe.pack_inner_weights(kp.cpu(), ku.cpu(), kd.cpu(), strategy)
    assert torch.equal(got.cpu(), want)
    ke = inner_probe.pack_weights(kp, ku, kd).view(3, 3, 256, 128)
    for st in inner_probe.inner_steps(strategy):
        tile = got[st.woff:st.woff + st.width * inner_probe.K_TILE].view(st.width, 64)
        k0 = {1: st.lane0, 0: 128, 2: 192}[st.plane]
        cols = slice(64, 128) if st.cols == inner_probe.HIGH else slice(0, st.width)
        assert torch.equal(inner_probe.swizzle_rows(tile).t(),
                           ke[st.dh + 1, st.dw + 1, k0:k0 + 64, cols]), st


def test_inner_step_rejects_views(cuda):
    """A non-contiguous or misaligned z (or packed weights) raises
    ``ValueError``, not a fault."""
    z, kp, ku, kd = inner_probe.inputs(2, 2, cuda)
    packed = inner_probe.pack_inner_weights(kp, ku, kd)
    strided = z.transpose(-1, -2).contiguous().transpose(-1, -2)     # z's shape, not contiguous
    with pytest.raises(ValueError):
        inner_probe.inner_step_packed(strided, packed, 2)
    with pytest.raises(ValueError):
        inner_probe.inner_step(strided, kp, ku, kd, 2)
    shifted = torch.empty(z.numel() + 1, dtype=z.dtype, device=cuda)[1:].view(z.shape)
    shifted.copy_(z)
    with pytest.raises(ValueError):
        inner_probe.inner_step(shifted, kp, ku, kd, 2)                    # 2 bytes off 16
    moved = torch.empty(packed.numel() + 1, dtype=packed.dtype, device=cuda)[1:]
    moved.copy_(packed)
    with pytest.raises(ValueError):
        inner_probe.inner_step_packed(z, moved, 2)                        # weights misaligned


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_out", [
    ((32, 16, 64, 64), 64),     # the TPU probe's C and D
    ((8, 12, 32, 32), 128),     # D 32: a 1 x 4 x 32 tile, 128 outputs
    (conv_prototype.SHAPE, conv_prototype.N_OUT),   # the TPU probe's main shape
])
def test_conv3d_cl_matches_plain(cuda, dtype, shape, n_out):
    x, k = conv_prototype.inputs(shape, n_out, cuda, dtype)
    before = conv_prototype.conv3d_cl.launches
    got = conv_prototype.conv3d_cl(x, k)
    torch.cuda.synchronize()
    assert conv_prototype.conv3d_cl.launches == before + 1
    want = conv_prototype.conv3d_cl_reference(x, k)
    assert got.dtype == dtype and got.shape == shape[:3] + (n_out,)
    assert _rel(got, want) <= PROBE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_out", [
    ((2, 16, 8, 64, 64), 64),     # the level-0 packed C4 = O4 = 64
    ((1, 8, 8, 64, 128), 128),    # the 8C-lane C4 = O4 = 128
    ((1, 6, 8, 32, 32), 64),
    conv_retired.SHAPES[0][1:],   # the TPU probe's main shape, level-0 packed
])
def test_conv3d_cl_rows_matches_plain(cuda, dtype, shape, n_out):
    xp, k, bias = conv_retired.inputs(shape, n_out, cuda, dtype)
    before = conv_retired.conv3d_cl_rows.launches
    got = conv_retired.conv3d_cl_rows(xp, k, bias)
    torch.cuda.synchronize()
    assert conv_retired.conv3d_cl_rows.launches == before + 1
    want = conv_retired.conv3d_cl_rows_reference(xp, k, bias)
    assert got.dtype == dtype and got.shape == shape[:4] + (n_out,)
    assert _rel(got, want) <= PROBE_TOL[dtype]


@pytest.mark.parametrize("shape,n_out", [
    ((1, 7, 9, 16, 32), 64),      # H, W not multiples of 4; D 16: half a d tile
    ((1, 5, 6, 48, 64), 128),     # D 48: one and a half d tiles
    ((1, 1, 3, 5, 96), 64),       # one ragged tile, three chunks
])
def test_conv3d_cl_rows_ragged_tiles(cuda, shape, n_out):
    xp, k, bias = conv_retired.inputs(shape, n_out, cuda)
    got = conv_retired.conv3d_cl_rows(xp, k, bias)
    want = conv_retired.conv3d_cl_rows_reference(xp, k, bias)
    assert got.shape == shape[:4] + (n_out,)
    assert _rel(got, want) <= PROBE_TOL[torch.bfloat16]
    for edge in ((slice(None), -1), (slice(None), slice(None), -1), (..., -1, slice(None))):
        assert _rel(got[edge], want[edge]) <= PROBE_TOL[torch.bfloat16]  # last h, w, d


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv3d_cl_rows_batch_two(cuda, dtype, with_bias):
    xp, k, bias = conv_retired.inputs((2, 8, 12, 32, 64), 64, cuda, dtype)
    bias = bias if with_bias else None
    got = conv_retired.conv3d_cl_rows(xp, k, bias)
    want = conv_retired.conv3d_cl_rows_reference(xp, k, bias)
    for b in (0, 1):
        assert _rel(got[b], want[b]) <= PROBE_TOL[dtype]


@pytest.mark.parametrize("k,row_bytes", [(16, 64), (16, 128), (64, 64), (64, 128)])
@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_wgmma_product_matches_matmul(cuda, n, k, row_bytes):
    """``ltu::wgmma_m64k16<N>`` alone (``pc_wgmma_product``), each width the
    probes take (the conv N 64, the tap sums 16, 32, 64 and 128): A from
    registers, B by a descriptor of a K-major tile of N rows with a 64- or
    128-byte swizzle, k / 16 descriptor steps (four at k 64). Exact bf16
    products summed in f32 in another order: 1e-5 of max |plain|."""
    g = torch.Generator(device="cpu").manual_seed(12)
    a = torch.randn((64, k), generator=g).to(cuda, torch.bfloat16)
    bt = torch.randn((n, k), generator=g).to(cuda, torch.bfloat16)
    out = torch.empty((64, n), device=cuda)
    err = kernels.load("probe_conv").pc_wgmma_product(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), n, k, row_bytes, 0,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert _rel(out, torch.matmul(a.float(), bt.float().t())) <= 1e-5


@pytest.mark.parametrize("k,row_bytes", [(16, 64), (16, 128), (64, 64), (64, 128)])
def test_wgmma_half_accumulator_matches_matmul(cuda, k, row_bytes):
    """m64n64k16 into each half of an m64n128 accumulator (``wgmma_m64n64k16<0>``
    and ``<32>``, what the inner-loop probe's neighbour taps run), after the
    m64n128k16 of the same operands: out is twice a @ bt^T, so columns
    0..63 are the first 32 registers and 64..127 the last 32. 1e-5 of max
    |plain| as above."""
    g = torch.Generator(device="cpu").manual_seed(13)
    a = torch.randn((64, k), generator=g).to(cuda, torch.bfloat16)
    bt = torch.randn((128, k), generator=g).to(cuda, torch.bfloat16)
    out = torch.empty((64, 128), device=cuda)
    err = kernels.load("probe_conv").pc_wgmma_product(
        a.data_ptr(), bt.data_ptr(), out.data_ptr(), 128, k, row_bytes, 1,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert _rel(out, 2 * torch.matmul(a.float(), bt.float().t())) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_probes_are_deterministic(cuda, dtype):
    xp, k, bias = conv_retired.inputs((1, 16, 16, 64, 64), 64, cuda, dtype)
    first = conv_retired.conv3d_cl_rows(xp, k, bias)
    assert torch.equal(first, conv_retired.conv3d_cl_rows(xp, k, bias))


@pytest.mark.parametrize("shape,scale", [((4, 16, 8, 256), 1.0), ((2, 24, 16, 128), 0.7),
                                         ((32, 128, 128, 128), 1.0)])  # the TPU probe's main
def test_lane_sums_matches_plain(cuda, shape, scale):
    x = in_stats_probe.inputs(shape, cuda)
    before = in_stats_probe.lane_sums.launches
    got = in_stats_probe.lane_sums(x, scale)
    torch.cuda.synchronize()
    assert in_stats_probe.lane_sums.launches == before + 1
    want = in_stats_probe.lane_sums_reference(x, scale)
    assert got.shape == want.shape and got.dtype == torch.float32
    for part in (0, 1):
        assert _rel(got[:, :, part], want[:, :, part]) <= 1e-5


def test_probes_reject_what_they_do_not_take(cuda):
    x, w = _probe_taps(1, 256, 128, 9, 64, cuda)
    with pytest.raises(TypeError):
        dot_probe.tap_sum(x.float(), w.float())
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x[:, ::2], w)
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x, w, offsets=[0] * 8)                  # 8 offsets, 9 taps
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x, w, acc_dtype=torch.float16)
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x, w[..., :48].contiguous())             # N 48
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x[..., :12].contiguous(), w[:, :12].contiguous())  # K 12
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    with pytest.raises(ValueError):
        dot_probe.tap_sum(shifted, w)                               # x 2 bytes off 16
    xc, k = conv_prototype.inputs((8, 8, 64, 64), 64, cuda)
    with pytest.raises(ValueError):
        conv_retired.conv3d_cl_rows(xc[None, ..., :48], k[..., :48, :], None)  # not contiguous
    with pytest.raises(ValueError):
        conv_prototype.conv3d_cl(xc[..., :48].contiguous(), k[..., :48, :].contiguous())  # C % 32
    with pytest.raises(ValueError):
        conv_retired.conv3d_cl_rows(xc[None, :, :, :48].float().contiguous(), k.float(),
                                    None)                               # f32 D 48
    with pytest.raises(ValueError):
        conv_prototype.conv3d_cl(xc, k[..., :32].contiguous())          # O % 64
    with pytest.raises(TypeError):
        conv_prototype.conv3d_cl(xc, k.float())
    with pytest.raises(TypeError):
        in_stats_probe.lane_sums(xc.float())


# (N, C, S1, S2, S3) of every depthwise convolution that the flagship's and
# the bottle model's training steps route to the kernel (the bottle model's
# one is the flagship's bottleneck shape), then ragged ones: voxel counts
# that split unevenly, channels that are not a multiple of 32, one voxel.
DEPTHWISE_ROUTED = [(3, 256, 8, 24, 14), (3, 256, 8, 16, 16), (3, 256, 8, 15, 9)]
DEPTHWISE_RAGGED = [(1, 256, 3, 5, 7), (2, 160, 1, 1, 1), (1, 300, 7, 9, 11), (5, 129, 2, 3, 1)]


def _depthwise_inputs(shape, layout, device, seed=0):
    """x and the output gradient in bf16, each laid out as the model's PEG
    lays them out (``channels_last``: a permuted view of (N, S1, S2, S3, C)
    tokens) or contiguous."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n, c, s1, s2, s3 = shape
    out = []
    for _ in range(2):
        t = torch.randn((n, s1, s2, s3, c), generator=g).to(device, torch.bfloat16)
        t = t.permute(0, 4, 1, 2, 3)
        out.append(t if layout == "channels_last" else t.contiguous())
    return out


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("shape", DEPTHWISE_ROUTED + DEPTHWISE_RAGGED)
def test_depthwise_wgrad_matches_plain(cuda, shape, layout):
    x, grad = _depthwise_inputs(shape, layout, cuda)
    before = cw.depthwise_weight_grad.launches
    got = cw.depthwise_weight_grad(x, grad)
    want = cw.depthwise_weight_grad_reference(x, grad)
    torch.cuda.synchronize()
    assert cw.depthwise_weight_grad.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * top


def test_depthwise_wgrad_is_deterministic(cuda):
    x, grad = _depthwise_inputs(DEPTHWISE_ROUTED[0], "channels_last", cuda)
    first = cw.depthwise_weight_grad(x, grad)
    second = cw.depthwise_weight_grad(x, grad)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _in_a_new_process(fn):
    """``fn()`` in a spawned process. In a process that has profiled many
    calls the profiler on the H100 keeps no device rows for long stretches
    (a run of this whole file loses them for its last few dozen tests; the
    host's launch calls stay), so a test of the kernels' names profiles in
    a process that has profiled nothing."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        return pool.apply_async(fn).get(timeout=300)


def _wgrad_call_profiled():
    x, grad = _depthwise_inputs(DEPTHWISE_ROUTED[1], "channels_last", torch.device("cuda"))
    return cuda_launches(lambda: cw.depthwise_weight_grad(x, grad))


def test_depthwise_wgrad_launches_conv_unit_kernels(cuda):
    """Two launches a call, each a kernel named ``conv_unit...`` (which the
    benchmark's cuDNN reader leaves out), and no cuDNN kernel."""
    seen = _in_a_new_process(_wgrad_call_profiled)
    assert len(seen.launches) == 2
    kernels = [r for r in seen.rows if not r.startswith(("Memcpy", "Memset"))]
    assert kernels and all("conv_unit" in r for r in kernels), kernels


@pytest.mark.parametrize("bias", [True, False])
def test_routed_conv_keeps_cudnn_forward_and_data_gradient(cuda, bias):
    """``ops.conv3d`` on a routed 256-channel convolution: the data and the
    bias gradients are F.conv3d's through autograd, to the bit, and the
    weight gradient is the kernel's. The forward is cuDNN's, to the bit, on
    a channels-first input; on the positional encoding's channels-last view
    it is ``conv_depthwise``'s kernel (one launch), within DEPTHWISE_TOL of
    cuDNN's. Under ``torch.inference_mode()`` the call gives the same
    forward, straight from the f32 weight, and launches no weight
    gradient."""
    from lintransunet_tpu_torch.ops import conv3d

    x_cl, g = _depthwise_inputs(DEPTHWISE_ROUTED[2], "channels_last", cuda, seed=1)
    gen = torch.Generator(device="cpu").manual_seed(2)
    w0 = (torch.randn((256, 1, 3, 3, 3), generator=gen) * 0.2).to(cuda)
    b0 = torch.randn((256,), generator=gen).to(cuda)
    for layout in ("channels_last", "contiguous"):
        x0 = x_cl if layout == "channels_last" else x_cl.contiguous()
        got, want = {}, {}
        for out, routed in ((got, True), (want, False)):
            x = x0.detach().clone().requires_grad_()
            w = w0.clone().requires_grad_()
            b = b0.clone().requires_grad_() if bias else None
            if routed:
                before = cw.depthwise_weight_grad.launches
                forwards = cd.conv_depthwise.launches
                y = conv3d(x, w, b, 1, 1, 256)
                assert type(y.grad_fn).__name__ == "DepthwiseConv3dBackward"
            else:
                y = F.conv3d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), 1, 1, 1,
                             256)
            y.backward(g)
            out.update(y=y.detach(), x=x.grad, w=w.grad, b=None if b is None else b.grad)
        assert cw.depthwise_weight_grad.launches == before + 1
        assert torch.equal(got["x"], want["x"]), layout
        if bias:
            assert torch.equal(got["b"], want["b"]), layout
        plain = cw.depthwise_weight_grad_reference(x0, g)
        assert (got["w"] - plain).abs().max().item() <= 1e-5 * plain.abs().max().item()
        if layout == "channels_last":
            assert cd.conv_depthwise.launches == forwards + 1
            assert torch.equal(got["y"], cd.conv_depthwise(x0, w0.to(x0.dtype),
                                                           b0.to(x0.dtype) if bias else None))
            err = (got["y"].float() - want["y"].float()).abs().max().item()
            assert err <= DEPTHWISE_TOL * want["y"].float().abs().max().item(), err
        else:
            assert cd.conv_depthwise.launches == forwards
            assert torch.equal(got["y"], want["y"])
        with torch.inference_mode():
            before = cw.depthwise_weight_grad.launches
            served = conv3d(x0, w0, b0 if bias else None, 1, 1, 256)
        assert cw.depthwise_weight_grad.launches == before
        assert torch.equal(served, got["y"]), layout


def test_depthwise_wgrad_rejects_what_it_does_not_take(cuda):
    x, grad = _depthwise_inputs((1, 256, 3, 4, 5), "contiguous", cuda)
    with pytest.raises(ValueError):
        cw.depthwise_weight_grad(x.float(), grad.float())
    with pytest.raises(ValueError):
        cw.depthwise_weight_grad(x, grad[:, :, :2])


# (N, C, O, (H, W, D)): the narrow-output convolutions of a flagship window
# batch (4) and micro-batch (3) (the final block, the mask heads of levels
# 0-3), each at both batches, then ragged ones: H and W off the tiles, channels not a multiple of 16,
# each output count, each depth the tiles take.
NARROW_ROUTED = [(4, 16, 8, (256, 256, 32)), (4, 32, 2, (256, 256, 32)),
                 (3, 64, 2, (128, 128, 32)), (3, 128, 2, (64, 64, 16)),
                 (4, 256, 2, (32, 32, 16)),
                 (3, 16, 8, (256, 256, 32)), (3, 32, 2, (256, 256, 32)),
                 (4, 64, 2, (128, 128, 32)), (4, 128, 2, (64, 64, 16)),
                 (3, 256, 2, (32, 32, 16))]
NARROW_RAGGED = [(1, 20, 5, (13, 9, 24)), (2, 16, 3, (7, 11, 64)), (1, 24, 8, (5, 6, 128)),
                 (1, 8, 4, (3, 3, 8)), (3, 40, 7, (9, 10, 40)), (1, 17, 2, (6, 5, 48)),
                 (2, 33, 1, (10, 3, 56)), (1, 5, 6, (4, 9, 96))]
NARROW_TOL = 2 ** -7


def _narrow_inputs(shape, device, weight_dtype=torch.float32, seed=0):
    n, c, o, spatial = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((n, c) + spatial, generator=g).to(device, torch.bfloat16)
    w = (torch.randn((o, c, 3, 3, 3), generator=g) / (c * 27) ** 0.5).to(device, weight_dtype)
    b = torch.randn((o,), generator=g).to(device, torch.bfloat16)
    return x, w, b


@pytest.mark.parametrize("weight_dtype,bias", [(torch.float32, True), (torch.bfloat16, False)])
@pytest.mark.parametrize("shape", NARROW_ROUTED + NARROW_RAGGED)
def test_narrow_conv_matches_plain(cuda, shape, weight_dtype, bias):
    x, w, b = _narrow_inputs(shape, cuda, weight_dtype)
    b = b if bias else None
    assert cn.routes(x, w, 1, 1, 1)
    before = cn.conv_narrow.launches
    got = cn.conv_narrow(x, w, b)
    want = cn.conv_narrow_reference(x, w, b)
    torch.cuda.synchronize()
    assert cn.conv_narrow.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= NARROW_TOL * want.float().abs().max().item(), err


def test_narrow_conv_is_deterministic(cuda):
    x, w, b = _narrow_inputs(NARROW_ROUTED[1], cuda)
    first = cn.conv_narrow(x, w, b)
    second = cn.conv_narrow(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_narrow_conv_reads_a_strided_input(cuda):
    """A non-contiguous or misaligned input is copied first: the same bits."""
    x, w, b = _narrow_inputs(NARROW_RAGGED[0], cuda)
    want = cn.conv_narrow(x, w, b)
    wider = torch.zeros(x.shape[:4] + (x.shape[4] + 8,), dtype=x.dtype, device=cuda)
    wider[..., 1:x.shape[4] + 1] = x
    got = cn.conv_narrow(wider[..., 1:x.shape[4] + 1], w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _narrow_call_profiled():
    x, w, b = _narrow_inputs(NARROW_ROUTED[0], torch.device("cuda"))
    return cuda_launches(lambda: cn.conv_narrow(x, w, b))


def test_narrow_conv_launches_conv_unit_narrow_kernels(cuda):
    """Two launches a call (the packing, the convolution), each a kernel
    named ``conv_unit_narrow...`` (which the benchmark's cuDNN reader leaves
    out and its ``narrow_conv_ms`` readers count), and no cuDNN kernel."""
    seen = _in_a_new_process(_narrow_call_profiled)
    assert len(seen.launches) == 2
    kernels = [r for r in seen.rows if not r.startswith(("Memcpy", "Memset"))]
    assert kernels and all("conv_unit_narrow" in r for r in kernels), kernels


@pytest.mark.parametrize("shape", [NARROW_ROUTED[0], NARROW_ROUTED[1], NARROW_RAGGED[6]])
def test_routed_narrow_conv_keeps_cudnn_gradients(cuda, shape):
    """``ops.conv3d`` on a routed convolution under grad: the forward is the
    kernel's, the input, weight and bias gradients are F.conv3d's through
    autograd, to the bit; under ``torch.inference_mode()`` it is the kernel
    straight from the f32 weight, the same bits."""
    from lintransunet_tpu_torch.ops import conv3d

    x0, w0, _ = _narrow_inputs(shape, cuda)
    b0 = torch.randn((shape[2],), generator=torch.Generator().manual_seed(5)).to(cuda)
    g = torch.randn((shape[0], shape[2]) + shape[3], generator=torch.Generator().manual_seed(6)
                    ).to(cuda, torch.bfloat16)
    got, want = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for out, routed in ((got, True), (want, False)):
            x = x0.detach().clone().requires_grad_()
            w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
            if routed:
                before = cn.conv_narrow.launches
                y = conv3d(x, w, b, 1, 1, 1)
                assert type(y.grad_fn).__name__ == "NarrowConv3dBackward"
            else:
                y = F.conv3d(x, w.to(x.dtype), b.to(x.dtype), 1, 1)
            y.backward(g)
            out.update(y=y.detach(), x=x.grad, w=w.grad, b=b.grad)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert cn.conv_narrow.launches == before + 1
    assert torch.equal(got["y"], cn.conv_narrow(x0, w0.to(torch.bfloat16), b0.to(x0.dtype)))
    for key in ("x", "w", "b"):
        assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
    with torch.inference_mode():
        served = conv3d(x0, w0, b0, 1, 1, 1)
    assert torch.equal(served, got["y"])


def test_narrow_conv_rejects_what_it_does_not_take(cuda):
    x, w, b = _narrow_inputs(NARROW_ROUTED[1], cuda)
    with pytest.raises(ValueError):
        cn.conv_narrow(x.float(), w, b)
    with pytest.raises(ValueError):
        cn.conv_narrow(x[..., :12], w, b)
    with pytest.raises(ValueError):
        cn.conv_narrow(x, torch.cat([w] * 5), None)
    with pytest.raises(ValueError):
        cn.conv_narrow(x, w, b.float())


# (N, C, S1, S2, S3) of the positional encodings' depthwise convolutions in a
# flagship window batch (4) and micro-batch (3): the bottleneck's (the bottle
# model's one) and the ROI bridges' at levels 3, 2 and 1 (PERF.md, section
# 6, row 14); then ragged ones: a partial 64-channel slab, crops off the
# kernel's 4 x 8 x 4 tiles, single voxels.
PEG_CALLS = [(n,) + call for n in (4, 3) for call in
             ((256, 8, 16, 16), (256, 8, 15, 9), (256, 8, 24, 14), (128, 16, 39, 23))]
PEG_RAGGED = [(1, 8, 1, 1, 1), (2, 72, 5, 9, 3), (1, 136, 3, 17, 6), (2, 256, 9, 8, 5),
              (1, 16, 2, 1, 30)]
DEPTHWISE_TOL = 2 ** -7


def _peg_inputs(shape, device, weight_dtype=torch.float32, seed=0):
    """x as the positional encoding hands it over (a permuted view of
    (N, S1, S2, S3, C) tokens), the weight in ``weight_dtype``, a bf16 bias."""
    n, c, s1, s2, s3 = shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((n, s1, s2, s3, c), generator=g).to(device, torch.bfloat16)
    w = (torch.randn((c, 1, 3, 3, 3), generator=g) * 0.2).to(device, weight_dtype)
    b = torch.randn((c,), generator=g).to(device, torch.bfloat16)
    return x.permute(0, 4, 1, 2, 3), w, b


@pytest.mark.parametrize("weight_dtype,bias", [(torch.float32, True), (torch.bfloat16, False)])
@pytest.mark.parametrize("shape", PEG_CALLS + PEG_RAGGED)
def test_depthwise_conv_matches_plain(cuda, shape, weight_dtype, bias):
    x, w, b = _peg_inputs(shape, cuda, weight_dtype)
    b = b if bias else None
    assert cd.routes(x, w, 1, 1, shape[1])
    before = cd.conv_depthwise.launches
    got = cd.conv_depthwise(x, w, b)
    want = cd.conv_depthwise_reference(x, w, b)
    torch.cuda.synchronize()
    assert cd.conv_depthwise.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert got.stride() == x.stride()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= DEPTHWISE_TOL * want.float().abs().max().item(), err


def test_depthwise_conv_is_deterministic(cuda):
    x, w, b = _peg_inputs(PEG_CALLS[3], cuda)
    first = cd.conv_depthwise(x, w, b)
    second = cd.conv_depthwise(x, w, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_depthwise_conv_rejects_what_it_does_not_take(cuda):
    x, w, b = _peg_inputs(PEG_CALLS[0], cuda)
    with pytest.raises(ValueError):
        cd.conv_depthwise(x.contiguous(), w, b)  # channels first
    with pytest.raises(ValueError):
        cd.conv_depthwise(x.float(), w, b)
    with pytest.raises(ValueError):
        cd.conv_depthwise(x[:, :12], w[:12], b[:12])  # 12 channels
    with pytest.raises(ValueError):
        cd.conv_depthwise(x, w, b.float())
    with pytest.raises(ValueError):
        cd.conv_depthwise(x, w.double(), b)


@pytest.mark.parametrize("name,pegs", [("MaskTransUnet", 4), ("BottleTransUnet", 1)])
def test_depthwise_conv_launches_a_forward(cuda, name, pegs):
    """A bf16 eval forward of the flagship, or the bottle model at its
    widths, on one 512 x 512 x 32 window runs the kernel once a positional
    encoding."""
    from lintransunet_tpu_torch.models import FLAGSHIP, get_model_dict, init_random_

    widths = FLAGSHIP if name == "MaskTransUnet" else {
        key: FLAGSHIP[key] for key in ("num_layers", "dim_input", "dim_output")}
    model = get_model_dict(name)(**widths, dtype=torch.bfloat16, device=cuda)
    init_random_(model, torch.Generator(device="cpu").manual_seed(0)).eval()
    window = torch.randn((1, 1, 512, 512, 32), generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        before = cd.conv_depthwise.launches
        model(window.to(cuda))
        torch.cuda.synchronize()
    assert cd.conv_depthwise.launches - before == pegs


def _graphed_micro_step_profiled():
    """(the device rows of one replayed bf16 micro-step of the flagship on
    one 512 x 512 x 32 patch, the replays in that call)."""
    from lintransunet_tpu_torch import engine
    from lintransunet_tpu_torch.cli.common import get_criterion_list
    from lintransunet_tpu_torch.models import flagship
    from lintransunet_tpu_torch.utils import profiling

    device = torch.device("cuda")
    model = flagship(0, dtype=torch.bfloat16, device=device, dropout=0.3).train()
    criterions, _ = get_criterion_list(5, ["CrossEntroLoss", "DiceClassLoss"])
    state = engine.create_train_state(model, 1e-4, step_times=2)
    step = engine.make_train_step(model, criterions)
    image = torch.randn((1, 1, 512, 512, 32), generator=torch.Generator().manual_seed(0))
    labels = torch.zeros((1, 512, 512, 32), dtype=torch.long)
    labels[:, 200:320, 220:300, 8:24] = 1
    image, labels = image.to(device), labels.to(device)
    weights = [0.15, 0.25, 0.4, 0.5, 1.0]
    gen = torch.Generator(device=device).manual_seed(3)
    for _ in range(3):  # the warm-up and both phases' captures
        step(state, image, labels, weights, gen)
    replayed = profiling.counts["step.replayed"]
    seen = cuda_launches(lambda: step(state, image, labels, weights, gen))
    return seen.rows, profiling.counts["step.replayed"] - replayed


def test_depthwise_conv_in_a_graphed_micro_step(cuda):
    """A replayed micro-step of the flagship runs the positional encodings'
    forwards on ``conv_unit_depthwise`` (the benchmark's
    ``depthwise_conv_ms.train`` reads that name), at most 4 device rows, and
    none on cuDNN's generic engine (``implicit_convolveNd_sgemm``)."""
    rows, replayed = _in_a_new_process(_graphed_micro_step_profiled)
    assert replayed == 1
    depthwise = [r for r in rows if "conv_unit_depthwise" in r]
    assert 0 < len(depthwise) <= 4, depthwise
    assert not [r for r in rows if "implicit_convolveNd_sgemm" in r]
