"""The readers of the narrow-output convolution kernel
(``narrow_conv_ms.serve``, ``narrow_conv_ms.train``) on synthetic traces
with known answers, their silence on a port without the kernel, and that
``cudnn_conv_ms`` leaves the kernel out."""

import pytest

from portbench.tests.test_portbench_graphed import _named_trace
from portbench.tests.test_portbench_program_spans import _ctx, _reader

NAMES = ["void (anonymous namespace)::conv_unit_narrow<3, 2, true>(...)",
         "void (anonymous namespace)::conv_unit_narrow_pack<float>(...)",
         "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
         "void other"]
CUDNN_ONLY = ["sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"]


@pytest.mark.parametrize("kind,other", [("serve", "train"), ("train", "serve")])
def test_narrow_conv_ms_on_a_known_trace(kind, other):
    """Two 1 ms kernels of the port's over 2 windows or 2 micro-steps."""
    read = _reader(f"narrow_conv_ms.{kind}")
    assert read(_ctx(kind, _named_trace(NAMES))) == pytest.approx(2 / 2)
    assert read(_ctx(other, _named_trace(NAMES))) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_narrow_conv_ms_reads_nothing_without_the_kernel(kind):
    read = _reader(f"narrow_conv_ms.{kind}")
    assert read(_ctx(kind, _named_trace(CUDNN_ONLY))) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_cudnn_conv_ms_leaves_the_narrow_kernel_out(kind):
    read = _reader(f"cudnn_conv_ms.{kind}")
    assert read(_ctx(kind, _named_trace(NAMES))) == pytest.approx(1 / 2)
