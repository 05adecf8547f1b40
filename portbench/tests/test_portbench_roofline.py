import pytest

from portbench import roofline

# the per-call bounds of the port's attention calls, as PERF.md's kernel table
# gives them (compulsory bytes at 3.35 TB/s; FLOPs at 989 TFLOP/s)
FORWARD_US = {(8, 4096, 32): 2.5, (8, 2160, 32): 1.3, (8, 5376, 32): 3.3, (4, 28704, 32): 8.8}
BACKWARD_US = {(8, 2048, 32): 2.2, (8, 1080, 32): 1.2, (8, 2688, 32): 2.9, (4, 14352, 32): 7.7}


@pytest.mark.parametrize("call,us", sorted(FORWARD_US.items()))
def test_forward_bound(call, us):
    assert roofline.attention_bound_s(*call) * 1e6 == pytest.approx(us, abs=0.05)


@pytest.mark.parametrize("call,us", sorted(BACKWARD_US.items()))
def test_backward_bound(call, us):
    assert roofline.attention_bound_s(*call, backward=True) * 1e6 == pytest.approx(us, abs=0.05)


def test_narrow_and_wide_calls_are_bound_by_bytes_and_operations():
    bh, n = 8, 4096
    assert roofline.attention_bound_s(bh, n, 2) == pytest.approx(
        4 * bh * n * 2 * 2 / roofline.HBM_BYTES_PER_S)
    wide = roofline.attention_bound_s(1, 1024, 4096)
    assert wide == pytest.approx(2 * 2 * 1024 * 4096 ** 2 / roofline.PEAK_BF16_FLOPS)


def test_total_adds_the_backward():
    calls = [(8, 2048, 32), (4, 14352, 32)]
    fwd = roofline.attention_bound_total_s(calls)
    both = roofline.attention_bound_total_s(calls, backward=True)
    assert both == pytest.approx(fwd + sum(roofline.attention_bound_s(*c, backward=True)
                                           for c in calls))
