import types

import pytest
import torch

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


def test_stack_and_conv_unit_counts():
    # one layer on 2048 tokens of 256 in 8 heads: 4 C x C projections, the
    # 2C feed-forward, the context and its product at d = 32
    b, n, c = 1, 2048, 256
    assert roofline.stack_flops(b, n, c, 1, 8) == 2 * n * (4 * c * c + 2 * 2 * c * c) + 2 * 2 * n * c * 32
    assert roofline.stack_bytes(b, n, c, 7) == 2 * n * c * 2 + 7 * (8 * c * c + 32 * c) * 4
    assert roofline.conv_unit_flops(4, 16, 16, 16, 1000) == 2 * 4 * 16 * 32 * 27 * 1000
    # inputs, output, bf16 weights, bias, the affine of xa and the sums
    assert roofline.conv_unit_bytes(1, 32, 32, 32, 100, 32) == (
        96 * 100 * 2 + 32 * 64 * 27 * 2 + 32 * 4 + 2 * 32 * 4 + 2 * 32 * 4)


def test_call_bound_is_the_larger_term():
    assert roofline.call_bound_s(989e12, 0) == pytest.approx(1.0)
    assert roofline.call_bound_s(0, 3.35e12) == pytest.approx(1.0)
    calls = [{"flops": 989e9, "bytes": 1}, {"flops": 1, "bytes": 3.35e9}]
    assert roofline.calls_bound_s(calls) == pytest.approx(2e-3)


# a traced stretch of 2 windows: each kernel a name and its device ms
KERNELS = [("void stack_pack_weights(float const*, float const*, __nv_bfloat16*, int, int)", 0.01),
           ("void (anonymous namespace)::stack_kv_mma<256>(__nv_bfloat16 const*, __nv_bfloat16 const*)", 0.2),
           ("void stack_ctx_combine(float const*, float const*, float const*, float*)", 0.02),
           ("void stack_apply_mma<256>(__nv_bfloat16 const*, __nv_bfloat16*)", 0.3),
           ("void (anonymous namespace)::conv_unit_mma<true, 32>(MmaArgs)", 1.5),
           ("stats_reduce(float const*, float*, int, int)", 0.1),
           ("void conv_unit_wgrad_dw<__nv_bfloat16>(float const*)", 5.0),
           ("void at::native::CatArrayBatchedCopy<stack_like>(...)", 7.0),
           ("void lta_out<8>(LtaArgs)", 9.0)]
STACK_MS, CONV_MS = 0.53, 1.6


def _kernel_trace():
    from portbench.trace import Trace

    cuda = torch.autograd.DeviceType.CUDA
    events, t = [], 0
    for corr, (name, ms) in enumerate(KERNELS, 1):
        d = round(ms * 1e6)
        events.append(types.SimpleNamespace(
            name=lambda n=name: n, start_ns=lambda t=t: t, duration_ns=lambda d=d: d,
            device_type=lambda: cuda, correlation_id=lambda c=corr: c))
        t += d
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return Trace(prof, 0, t)


@pytest.mark.parametrize("name,key,ms", [("stack_roofline.serve", "stack_calls", STACK_MS),
                                         ("conv_unit_roofline.serve", "conv_unit_calls", CONV_MS)])
def test_kernel_roofline_readers(name, key, ms):
    from portbench import generate

    config = generate.load_json("configs", "masktransunet-pancreas-fused")
    read = _reader(name)
    ctx = {"kind": "serve", "trace": _kernel_trace(), "traced_windows": 2, "config": config}
    want = roofline.calls_bound_s(config[key]["window"]) * 2 / (ms * 1e-3) * 100
    assert read(ctx) == pytest.approx(want, rel=1e-6)
    assert read(dict(ctx, config=generate.load_json("configs", "masktransunet-pancreas"))) is None
    assert read(dict(ctx, kind="train")) is None
    empty = _kernel_trace()
    empty.kernels = [k for k in empty.kernels if "lta_" in k[2]]
    assert read(dict(ctx, trace=empty)) is None  # nothing to read, never 0


def _reader(name):
    import importlib.util
    import os

    from portbench import harness

    path = os.path.join(harness.ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
