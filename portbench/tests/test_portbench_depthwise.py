"""The readers of the depthwise-convolution kernel
(``depthwise_conv_ms.serve``, ``depthwise_conv_ms.train``) on synthetic
traces with known answers, their silence on a port without the kernel, and
that ``cudnn_conv_ms`` and ``narrow_conv_ms`` leave the kernel out."""

import pytest

from portbench.tests.test_portbench_graphed import _named_trace
from portbench.tests.test_portbench_program_spans import _ctx, _reader

NAMES = ["void (anonymous namespace)::conv_unit_depthwise((anonymous namespace)::Args)",
         "void (anonymous namespace)::conv_unit_depthwise((anonymous namespace)::Args)",
         "void implicit_convolveNd_sgemm<__nv_bfloat16, 3, 1024, 5, 5, 3, 3, 3, 1, false>(...)",
         "void other"]
CUDNN_ONLY = ["void implicit_convolveNd_sgemm<__nv_bfloat16, 3, 1024, 5, 5, 3, 3, 3, 1, false>(...)",
              "void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16>(...)"]


@pytest.mark.parametrize("kind,other", [("serve", "train"), ("train", "serve")])
def test_depthwise_conv_ms_on_a_known_trace(kind, other):
    """Two 1 ms kernels of the port's over 2 windows or 2 micro-steps."""
    read = _reader(f"depthwise_conv_ms.{kind}")
    assert read(_ctx(kind, _named_trace(NAMES))) == pytest.approx(2 / 2)
    assert read(_ctx(other, _named_trace(NAMES))) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_depthwise_conv_ms_reads_nothing_without_the_kernel(kind):
    read = _reader(f"depthwise_conv_ms.{kind}")
    assert read(_ctx(kind, _named_trace(CUDNN_ONLY))) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_other_conv_readers_leave_the_depthwise_kernel_out(kind):
    assert _reader(f"cudnn_conv_ms.{kind}")(_ctx(kind, _named_trace(NAMES))) == pytest.approx(1 / 2)
    assert _reader(f"narrow_conv_ms.{kind}")(_ctx(kind, _named_trace(NAMES))) is None
