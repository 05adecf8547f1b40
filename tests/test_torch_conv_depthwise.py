"""The routing of ``ops.conv3d`` to the depthwise-convolution kernel, its
plain version and the autograd Function that carries it under grad, on the
CPU (torch only).

The kernel itself runs on the card (``tests/test_torch_cuda.py``). Here:
which convolutions the kernel takes (by dtype, layout, channels, groups,
kernel, stride, padding and rank) and that no CPU tensor routes; that the
plain version is f32 ``F.conv3d`` of the bf16-rounded operands, laid out
channels last, and counts no launch; that ``conv_wgrad.DepthwiseConv3d``,
which carries the routed calls under grad, gives the forward, data, weight
and bias gradients of autograd through ``F.conv3d`` to the bit at 128
channels, and at 256 the same but for the weight gradient, which is the
plain f32 one of ``conv_wgrad``; and that a CPU model's positional encoding
gives ``F.conv3d``'s bits as before.
"""

import pytest
import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.models import ConvPosEmbed3d
from lintransunet_tpu_torch.models.blocks import peg_on_tokens
from lintransunet_tpu_torch.ops import conv3d
from lintransunet_tpu_torch.ops import conv_depthwise as cd
from lintransunet_tpu_torch.ops import conv_wgrad as cw

torch.set_num_threads(2)

BF = torch.bfloat16


def _channels_last(n, c, spatial, dtype=BF, seed=0):
    """(N, C, S1, S2, S3) as the PEG hands it over: a permuted view of
    (N, S1, S2, S3, C) tokens."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n,) + spatial + (c,), generator=g).to(dtype).permute(0, 4, 1, 2, 3)


def _weights(c, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((c, 1, 3, 3, 3), generator=g) * 0.2, torch.randn((c,), generator=g)


@pytest.mark.parametrize("case,taken", [
    ("peg", True),                  # a 256-channel PEG on its tokens' view
    ("peg128", True),               # level 1's 128-channel PEG
    ("c8", True),                   # any multiple of 8
    ("tuples", True),               # stride and padding as triples
    ("f32", False),                 # an f32 model
    ("channels_first", False),      # a contiguous (N, C, S1, S2, S3) input
    ("c12", False),                 # C not a multiple of 8
    ("groups", False),              # groups != C
    ("multiplier", False),          # a channel multiplier: 2C outputs
    ("kernel1", False),
    ("kernel5", False),
    ("stride2", False),
    ("padding0", False),
    ("2d", False),                  # ConvPosEmbed2d's rank
    ("strided", False),             # every second voxel: not dense
])
def test_which_convolutions_the_kernel_takes(case, taken):
    c, kernel, stride, padding, groups, outputs = 256, 3, 1, 1, 256, 256
    x = _channels_last(2, 256, (3, 4, 5))
    if case == "peg128":
        c = groups = outputs = 128
        x = _channels_last(2, 128, (3, 4, 5))
    elif case == "c8":
        c = groups = outputs = 8
        x = _channels_last(1, 8, (2, 2, 2))
    elif case == "tuples":
        stride, padding = (1, 1, 1), [1, 1, 1]
    elif case == "f32":
        x = x.float()
    elif case == "channels_first":
        x = x.contiguous()
    elif case == "c12":
        c = groups = outputs = 12
        x = _channels_last(1, 12, (2, 3, 4))
    elif case == "groups":
        groups = 128
    elif case == "multiplier":
        outputs = 512
    elif case == "kernel1":
        kernel, padding = 1, 0
    elif case == "kernel5":
        kernel, padding = 5, 2
    elif case == "stride2":
        stride = 2
    elif case == "padding0":
        padding = 0
    elif case == "strided":
        x = _channels_last(2, 256, (3, 4, 10))[..., ::2]
    w = torch.randn((outputs, c // groups) + (kernel,) * 3)
    if case == "2d":
        x, w = x[:, :, 0], w[:, :, 0]
    assert cd.takes(x, w, stride, padding, groups) is taken
    # a CPU tensor never routes: the CPU keeps F.conv3d
    assert cd.routes(x, w, stride, padding, groups) is False


# the PEG calls' shapes (ROADMAP D.1) with their depth and crops scaled down
@pytest.mark.parametrize("n,c,spatial", [(3, 256, (2, 6, 4)), (4, 256, (2, 4, 4)),
                                         (4, 128, (4, 10, 6)), (3, 256, (2, 4, 3)),
                                         (1, 8, (1, 1, 1))])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("weight_dtype", [torch.float32, BF])
def test_plain_version_is_f32_conv_of_rounded_operands(n, c, spatial, bias, weight_dtype):
    x = _channels_last(n, c, spatial)
    w, b = _weights(c)
    w = w.to(weight_dtype)
    b = b.to(BF) if bias else None
    before = cd.conv_depthwise.launches
    got = cd.conv_depthwise(x, w, b)
    assert cd.conv_depthwise.launches == before
    rounded = [None if t is None else t.to(BF).float() for t in (x, w, b)]
    want = F.conv3d(*rounded, 1, 1, 1, c).to(BF)
    assert got.dtype == BF and torch.equal(got, want)
    # the kernel's layout: the input's channels-last view
    assert got.stride() == x.stride()
    # within bf16 rounding of the exact convolution
    exact = F.conv3d(*[None if t is None else t.double() for t in rounded], 1, 1, 1, c)
    assert (got.double() - exact).abs().max().item() <= 2 ** -7 * exact.abs().max().item()


def test_plain_version_rejects_other_devices():
    x = _channels_last(1, 8, (2, 2, 2))
    w, _ = _weights(8)
    with pytest.raises(ValueError):
        cd.conv_depthwise(x.to("meta"), w.to("meta"))


def _through_the_function(c, routed, wants, bias):
    """y and the three gradients of a depthwise convolution of a
    channels-last bf16 input with an f32 weight and bias: through
    ``DepthwiseConv3d`` (routed) or autograd through ``F.conv3d``."""
    x0 = _channels_last(2, c, (3, 4, 5))
    w0, b0 = _weights(c)
    g = _channels_last(2, c, (3, 4, 5), seed=7)
    x = x0.clone().requires_grad_(wants[0])
    w = w0.clone().requires_grad_(wants[1])
    b = b0.clone().requires_grad_(wants[2]) if bias else None
    bb = None if b is None else b.to(BF)
    if routed:
        y = cw.DepthwiseConv3d.apply(x, w, bb)
        assert type(y.grad_fn).__name__ == "DepthwiseConv3dBackward"
    else:
        y = F.conv3d(x, w.to(BF), bb, 1, 1, 1, c)
    y.backward(g)
    return x0, g, [y.detach()] + [None if t is None else t.grad for t in (x, w, b)]


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("wants", [(True, True, True), (False, True, True), (True, False, False)])
def test_function_gradients_are_autograd_through_conv3d(c, bias, wants):
    """At 128 channels every output of ``DepthwiseConv3d`` is autograd's
    through ``F.conv3d``, to the bit (cuDNN's weight gradient there, as
    today); at 256 the forward, data and bias gradients are, and the weight
    gradient is ``conv_wgrad``'s plain f32 one."""
    x0, g, got = _through_the_function(c, True, wants, bias)
    _, _, want = _through_the_function(c, False, wants, bias)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if a is None:
            continue
        assert a.dtype == b.dtype, i
        if i == 2 and c > cw.ENGINE_CHANNELS:
            assert torch.equal(a, cw.depthwise_weight_grad_reference(x0, g)), i
        else:
            assert torch.equal(a, b), i


@pytest.mark.parametrize("c", [128, 256])
@pytest.mark.parametrize("train", [True, False])
def test_a_cpu_model_positional_encoding_is_unchanged(c, train):
    """A CPU model's PEG on its tokens gives ``F.conv3d``'s bits, with and
    without grad, and launches nothing."""
    torch.manual_seed(0)
    peg = ConvPosEmbed3d(c, 0.0).train(train)
    n, (d, h, w) = 2, (3, 4, 5)
    tokens = torch.randn((n, d * h * w, c)).to(BF)
    before = cd.conv_depthwise.launches
    with torch.set_grad_enabled(train):
        got = peg_on_tokens(tokens, (h, w, d), peg)
        grid = tokens.reshape(n, d, h, w, c).permute(0, 4, 1, 2, 3)
        proj = F.conv3d(grid, peg.proj.weight.to(BF), peg.proj.bias.to(BF), 1, 1, 1, c)
        want = (grid + proj).permute(0, 2, 3, 4, 1).reshape(n, d * h * w, c)
    assert cd.conv_depthwise.launches == before
    assert torch.equal(got, want)
    with torch.inference_mode():
        assert torch.equal(peg_on_tokens(tokens, (h, w, d), peg), want.detach())
    direct = conv3d(grid, peg.proj.weight.detach(), peg.proj.bias.detach(), 1, 1, c)
    assert torch.equal(direct, proj.detach())
