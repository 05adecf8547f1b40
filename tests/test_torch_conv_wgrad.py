"""The routing of ``ops.conv3d`` to the depthwise weight-gradient kernel,
and its plain version, on the CPU (torch only).

The kernel itself runs on the card (``tests/test_torch_cuda.py``). Here:
which convolutions route (by dtype, kernel, stride, padding, groups and
channels; never under ``torch.inference_mode()`` or ``torch.no_grad()``, or
for a weight that wants no gradient), that a routed call on the CPU takes
the plain version and counts no launch, that ``DepthwiseConv3d`` keeps the
forward, data and bias gradients of ``F.conv3d`` and gives the f32 weight
gradient, and the kernel's split of the voxels. Tolerances: the plain
weight gradient against f64 autograd 1e-5 of its largest magnitude (f32
sums of bf16 products against exact ones); data and bias gradients equal
to the bit (the same calls); the plain gradient of a permuted view against
the contiguous copy's 1e-5 (the CPU sums in another order by layout).
"""

import pytest
import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.models import ConvPosEmbed3d
from lintransunet_tpu_torch.ops import conv3d
from lintransunet_tpu_torch.ops import conv_wgrad as cw

torch.set_num_threads(2)

BF = torch.bfloat16


def _conv(c_in, c_out, kernel, groups, dtype=BF, shape=(1, 4, 5, 6)):
    x = torch.randn((shape[0], c_in) + shape[1:]).to(dtype)
    w = torch.randn((c_out, c_in // groups) + (kernel,) * 3, requires_grad=True)
    return x, w


@pytest.mark.parametrize("dtype,kernel,stride,padding,groups,c_in,c_out,routed", [
    (BF, 3, 1, 1, 256, 256, 256, True),                  # the flagship's PEG
    (BF, 3, (1, 1, 1), (1, 1, 1), 160, 160, 160, True),  # any depthwise width over 128
    (BF, 3, 1, 1, 128, 128, 128, False),                 # cuDNN's implicit GEMM takes 128
    (torch.float32, 3, 1, 1, 256, 256, 256, False),      # f32 never reaches the engine
    (BF, 1, 1, 0, 256, 256, 256, False),                 # 1x1x1
    (BF, 3, 2, 1, 256, 256, 256, False),                 # strided
    (BF, 3, (2, 2, 1), 1, 256, 256, 256, False),
    (BF, 3, 1, 0, 256, 256, 256, False),                 # unpadded
    (BF, 3, 1, 1, 1, 256, 256, False),                   # dense
    (BF, 3, 1, 1, 128, 256, 256, False),                 # grouped, not depthwise
    (BF, 3, 1, 1, 256, 256, 512, False),                 # a channel multiplier
    (BF, 3, 1, 1, 1, 4, 16, False),                      # the input block
    (BF, 3, 1, 1, 1, 16, 8, False),                      # the final block
    (BF, 3, 1, 1, 1, 32, 2, False),                      # a mask head
])
def test_routing_predicate(dtype, kernel, stride, padding, groups, c_in, c_out, routed):
    x, w = _conv(c_in, c_out, kernel, groups, dtype)
    assert cw.routes(x, w, stride, padding, groups) is routed


def test_never_routes_without_a_weight_gradient():
    x, w = _conv(256, 256, 3, 256)
    with torch.inference_mode():
        assert not cw.routes(x, w, 1, 1, 256)
    with torch.no_grad():
        assert not cw.routes(x, w, 1, 1, 256)
    assert not cw.routes(x, w.detach(), 1, 1, 256)


def test_routed_call_takes_the_plain_version_on_cpu():
    """Forward, data and bias gradients equal F.conv3d's through autograd;
    the weight gradient is the plain f32 one; no launch is counted."""
    x0, w0 = _conv(256, 256, 3, 256, shape=(2, 3, 4, 5))
    w0 = w0.detach() * 0.1
    b0 = torch.randn(256)
    g = torch.randn((2, 256, 3, 4, 5)).to(BF)
    results = []
    for routed in (True, False):
        x = x0.clone().requires_grad_()
        w, b = w0.clone().requires_grad_(), b0.clone().requires_grad_()
        before = cw.depthwise_weight_grad.launches
        if routed:
            y = conv3d(x, w, b, 1, 1, 256)
            assert type(y.grad_fn).__name__ == "DepthwiseConv3dBackward"
        else:
            y = F.conv3d(x, w.to(BF), b.to(BF), 1, 1, 1, 256)
        y.backward(g)
        assert cw.depthwise_weight_grad.launches == before
        results.append((y.detach(), x.grad, w.grad, b.grad))
    (y, gx, gw, gb), (y_want, gx_want, _, gb_want) = results
    assert torch.equal(y, y_want) and torch.equal(gx, gx_want) and torch.equal(gb, gb_want)
    assert gw.dtype == torch.float32
    assert torch.equal(gw, cw.depthwise_weight_grad_reference(x0, g))


@pytest.mark.parametrize("shape", [(1, 256, 3, 5, 7), (2, 130, 1, 1, 1), (1, 160, 4, 2, 3)])
def test_plain_weight_gradient_is_f64_autograd(shape):
    x = torch.randn(shape).to(BF)
    g = torch.randn(shape).to(BF)
    got = cw.depthwise_weight_grad(x, g)
    w = torch.zeros((shape[1], 1, 3, 3, 3), dtype=torch.float64, requires_grad=True)
    F.conv3d(x.double(), w, None, 1, 1, 1, shape[1]).backward(g.double())
    want = w.grad
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_plain_weight_gradient_reads_any_layout():
    """The model's PEG convolves a permuted view of its tokens."""
    tokens = torch.randn((1, 3, 4, 5, 256)).to(BF)
    g = torch.randn((1, 256, 3, 4, 5)).to(BF)
    view = tokens.permute(0, 4, 1, 2, 3)
    got = cw.depthwise_weight_grad(view, g)
    want = cw.depthwise_weight_grad(view.contiguous(), g)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_rejects_mismatched_shapes():
    x = torch.randn((1, 256, 3, 4, 5)).to(BF)
    with pytest.raises(ValueError):
        cw.depthwise_weight_grad(x, x[:, :, :2])
    with pytest.raises(ValueError):
        cw.depthwise_weight_grad(x[0], x[0])


def test_the_model_peg_routes_in_training_only():
    peg = ConvPosEmbed3d(256, 0.0).train()
    x = torch.randn((1, 256, 2, 3, 4)).to(BF)
    assert type(peg.proj(x).grad_fn).__name__ == "DepthwiseConv3dBackward"
    with torch.inference_mode():
        assert peg.proj(x).grad_fn is None


@pytest.mark.parametrize("channels,voxels,sms", [(256, 8064, 132), (256, 10, 132),
                                                 (160, 1, 132), (32, 10 ** 6, 132),
                                                 (1024, 5000, 8)])
def test_split_covers_the_voxels(channels, voxels, sms):
    chunks = cw.chunks(channels, voxels, sms)
    chunk = -(-voxels // chunks)
    assert 1 <= chunks <= max(1, -(-voxels // cw.MIN_CHUNK))
    assert chunk * chunks >= voxels and chunk * (chunks - 1) < voxels or chunks == 1
