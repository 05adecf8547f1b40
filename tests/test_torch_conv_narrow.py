"""The routing of ``ops.conv3d`` to the narrow-output convolution kernel,
its plain version and its autograd Function, on the CPU (torch only).

The kernel itself runs on the card (``tests/test_torch_cuda.py``). Here:
which convolutions the kernel takes (by dtype, groups, stride, kernel,
padding, outputs and depth) and that no CPU tensor routes; that the plain
version is f32 ``F.conv3d`` of the bf16-rounded operands and counts no
launch; that ``NarrowConv3d``'s input, weight and bias gradients are those
of autograd through ``F.conv3d``, to the bit (the same cuDNN-or-CPU call);
and that ``ops.conv3d`` on a CPU model gives ``F.conv3d``'s bits as before.
"""

import pytest
import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.models.blocks import Conv3d
from lintransunet_tpu_torch.ops import conv3d
from lintransunet_tpu_torch.ops import conv_narrow as cn

torch.set_num_threads(2)

BF = torch.bfloat16


def _conv(c_in, c_out, kernel, groups=1, dtype=BF, shape=(2, 5, 6, 16), seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((shape[0], c_in) + shape[1:], generator=g).to(dtype)
    w = torch.randn((c_out, c_in // groups) + (kernel,) * 3, generator=g) * 0.1
    return x, w


@pytest.mark.parametrize("dtype,kernel,stride,padding,groups,c_in,c_out,depth,taken", [
    (BF, 3, 1, 1, 1, 16, 8, 32, True),                 # the final block
    (BF, 3, (1, 1, 1), (1, 1, 1), 1, 32, 2, 32, True),  # mask head, level 0
    (BF, 3, 1, 1, 1, 256, 2, 16, True),                # mask head, level 3
    (BF, 3, 1, 1, 1, 64, 1, 16, True),                 # one output
    (BF, 3, 1, 1, 1, 20, 5, 64, True),                 # any width, up to 8 outputs
    (BF, 3, 1, 1, 1, 16, 8, 128, True),                # the deepest depth
    (BF, 3, 1, 1, 1, 16, 8, 8, True),
    (torch.float32, 3, 1, 1, 1, 16, 8, 32, False),     # f32
    (BF, 3, 1, 1, 16, 16, 16, 32, False),              # groups > 1 (depthwise)
    (BF, 3, 1, 1, 2, 16, 8, 32, False),                # grouped
    (BF, 3, 2, 1, 1, 16, 8, 32, False),                # stride 2
    (BF, 3, (2, 2, 1), 1, 1, 16, 8, 32, False),
    (BF, 3, 1, 1, 1, 16, 16, 32, False),               # 16 outputs
    (BF, 3, 1, 1, 1, 16, 9, 32, False),
    (BF, 5, 1, 2, 1, 16, 8, 32, False),                # kernel 5
    (BF, 3, 1, 0, 1, 16, 8, 32, False),                # padding 0 with kernel 3
    (BF, 1, 1, 0, 1, 16, 1, 32, False),                # 1x1x1: a gate's psi stays on cuBLAS
    (BF, 1, 1, 0, 1, 128, 1, 16, False),
    (BF, 1, 1, 1, 1, 16, 1, 32, False),                # padding 1 with kernel 1
    (BF, 3, 1, 1, 1, 16, 8, 12, False),                # a depth not a multiple of 8
    (BF, 3, 1, 1, 1, 16, 8, 136, False),               # deeper than the tiles
])
def test_which_convolutions_the_kernel_takes(dtype, kernel, stride, padding, groups, c_in,
                                            c_out, depth, taken):
    x, w = _conv(c_in, c_out, kernel, groups, dtype, shape=(1, 3, 4, depth))
    assert cn.takes(x, w, stride, padding, groups) is taken
    # a CPU tensor never routes: the CPU keeps F.conv3d
    assert cn.routes(x, w, stride, padding, groups) is False


@pytest.mark.parametrize("c_in,c_out,bias", [(16, 8, True), (32, 2, True), (20, 5, False),
                                             (40, 1, True), (17, 3, False)])
@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_plain_version_is_f32_conv_of_rounded_operands(c_in, c_out, bias, dtype):
    x, w = _conv(c_in, c_out, 3, dtype=dtype)
    b = torch.randn(c_out) if bias else None
    before = cn.conv_narrow.launches
    got = cn.conv_narrow(x, w, b)
    assert cn.conv_narrow.launches == before
    rounded = [None if t is None else t.to(BF).float() for t in (x, w, b)]
    want = F.conv3d(*rounded, 1, 1).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    # within bf16 rounding of the exact convolution
    exact = F.conv3d(*[None if t is None else t.double() for t in rounded], 1, 1)
    assert (got.double() - exact).abs().max().item() <= 2 ** -7 * exact.abs().max().item()


def test_plain_version_rejects_other_devices():
    x, w = _conv(16, 8, 3)
    with pytest.raises(ValueError):
        cn.conv_narrow(x.to("meta"), w.to("meta"))


@pytest.mark.parametrize("c_in,c_out", [(16, 8), (32, 2), (20, 1)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("wants", [(True, True, True), (False, True, True), (True, False, False)])
def test_gradients_are_autograd_through_conv3d(c_in, c_out, bias, wants):
    """f32 on the CPU: the forward is the plain version, the gradients are
    convolution_backward's, as autograd computes them for F.conv3d."""
    x0, w0 = _conv(c_in, c_out, 3, dtype=torch.float32)
    b0 = torch.randn(c_out) if bias else None
    g = torch.randn((2, c_out, 5, 6, 16))
    grads = []
    for routed in (True, False):
        x, w = x0.clone().requires_grad_(wants[0]), w0.clone().requires_grad_(wants[1])
        b = None if b0 is None else b0.clone().requires_grad_(wants[2])
        if routed:
            y = cn.NarrowConv3d.apply(x, w, b)
            assert type(y.grad_fn).__name__ == "NarrowConv3dBackward"
        else:
            y = F.conv3d(x, w, b, 1, 1)
        y.backward(g)
        grads.append([None if t is None else t.grad for t in (x, w, b)])
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if got is not None:
            assert torch.equal(got, want)


def test_dispatch_records_the_function_only_under_grad():
    x, w = _conv(32, 2, 3)
    w.requires_grad_()
    b = torch.zeros(2, dtype=BF)
    y = cn.conv3d(x, w, b)
    assert type(y.grad_fn).__name__ == "NarrowConv3dBackward"
    with torch.inference_mode():
        assert cn.conv3d(x, w, b).grad_fn is None
    with torch.no_grad():
        assert cn.conv3d(x, w, b).grad_fn is None


@pytest.mark.parametrize("c_in,c_out,kernel", [(16, 8, 3), (32, 2, 3), (16, 1, 1)])
@pytest.mark.parametrize("grad", [True, False])
def test_ops_conv3d_on_a_cpu_model_is_unchanged(c_in, c_out, kernel, grad):
    """A CPU model's narrow convolution is F.conv3d's, bit for bit, with
    F.conv3d's backward."""
    torch.manual_seed(0)
    layer = Conv3d(c_in, c_out, kernel, padding=kernel // 2)
    x = torch.randn((1, c_in, 4, 5, 16)).to(BF)
    with torch.set_grad_enabled(grad):
        got = layer(x)
        want = F.conv3d(x, layer.weight.to(BF), layer.bias.to(BF), 1, kernel // 2)
    assert torch.equal(got, want)
    if grad:
        assert type(got.grad_fn).__name__ != "NarrowConv3dBackward"
    direct = conv3d(x, layer.weight.detach(), layer.bias.detach(), 1, kernel // 2)
    assert torch.equal(direct, want.detach())
