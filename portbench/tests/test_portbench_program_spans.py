"""The per-layer readers of the port's own spans (``portbench/program_spans.py``
and the ``metrics/*`` that use it) on synthetic traces with known
answers, and ``trace.Trace`` beside the port's profiler ranges."""

import importlib.util
import os
import types

import pytest
import torch

from portbench import harness, program_spans
from portbench import trace as tracing
from lintransunet_tpu_torch.utils import profiling

START = 10 ** 18  # the stretch's start, ns on the host clock
MS = 10 ** 6
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def _event(name, start_ms, end_ms, device=CPU, corr=0):
    start, end = START + round(start_ms * MS), START + round(end_ms * MS)
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start,
                                 duration_ns=lambda: end - start,
                                 device_type=lambda: device, correlation_id=lambda: corr)


def _trace(kernels, window_ms=100.0, unlinked=0, extra=()):
    """A Trace of ``kernels`` [(launch ms, device start ms, device end ms)],
    ``unlinked`` more kernels without their launch, and ``extra`` events."""
    events = list(extra)
    for corr, (launch, s, t) in enumerate(kernels, 1):
        events.append(_event("cudaLaunchKernel", launch, launch + 0.01, corr=corr))
        events.append(_event("void kernel", s, t, CUDA, corr))
    for i in range(unlinked):
        events.append(_event("void unlinked", 99.0, 99.001, CUDA, 10_000 + i))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return tracing.Trace(prof, START, START + round(window_ms * MS))


def _spans(monkeypatch, spans):
    monkeypatch.setattr(profiling, "recorded", lambda: [
        (name, START + round(s * MS), START + round(t * MS)) for name, s, t in spans])


def _reader(name):
    path = os.path.join(harness.ROOT, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# a runner call of one volume, two windows in one forward: ms from the stretch's start
SERVE_SPANS = [("runner", 0, 100), ("runner.gather", 2, 8), ("model", 10, 60),
               ("encoder.embed", 10, 15), ("encoder.level1", 15, 25), ("bridge.level4", 25, 30),
               ("decoder.level3", 30, 50), ("bridge.level3", 35, 45), ("decoder.head", 50, 60),
               ("runner.finish", 62, 68), ("copy_in", -5, -1)]  # the last before the stretch
SERVE_KERNELS = [(12, 20, 22), (20, 22, 25),  # encoder: 5 ms
                 (27, 30, 34), (40, 41, 46),  # bridges: 9 ms
                 (32, 40, 41), (55, 56, 58),  # decoder outside the bridges: 3 ms
                 (70, 70, 80)]                # the runner outside the model: 10 ms
# busy [20,25] [30,34] [40,46] [56,58] [70,80]: idle in the model 10+5+6+10+2 ms,
# in the runner outside it [0,10] [60,70] [80,100]
SERVE = {"encoder_ms.serve": 5 / 2, "bridges_ms.serve": 9 / 2, "decoder_ms.serve": 3 / 2,
         "forward_idle_ms.serve": 33 / 2, "runner_idle_ms.serve": 40.0}


def _ctx(kind, trace):
    if kind == "serve":
        return {"kind": "serve", "trace": trace, "traced_windows": 2, "traced_volumes": 1}
    return {"kind": "train", "trace": trace, "traced_steps": 2}


@pytest.mark.parametrize("name,want", sorted(SERVE.items()))
def test_reader_on_a_known_trace(name, want, monkeypatch):
    _spans(monkeypatch, SERVE_SPANS)
    read = _reader(name)
    assert read(_ctx("serve", _trace(SERVE_KERNELS))) == pytest.approx(want, abs=1e-6)
    assert read(_ctx("train", _trace(SERVE_KERNELS))) is None


@pytest.mark.parametrize("name", sorted(SERVE))
def test_reader_reads_nothing_without_its_spans(name, monkeypatch):
    read = _reader(name)
    _spans(monkeypatch, [])
    assert read(_ctx("serve", _trace(SERVE_KERNELS))) is None
    monkeypatch.delattr(profiling, "recorded")  # a port without the spans
    assert read(_ctx("serve", _trace(SERVE_KERNELS))) is None


@pytest.mark.parametrize("name", sorted(SERVE))
def test_reader_reads_nothing_under_90_percent_linked(name, monkeypatch):
    _spans(monkeypatch, SERVE_SPANS)
    read = _reader(name)
    assert read(_ctx("serve", _trace(SERVE_KERNELS, unlinked=0))) is not None
    trace = _trace(SERVE_KERNELS, unlinked=len(SERVE_KERNELS) // 9 + 1)
    assert trace.linked_share() < program_spans.LINKED
    assert read(_ctx("serve", trace)) is None


def test_spans_outside_the_stretch_are_left_out(monkeypatch):
    _spans(monkeypatch, SERVE_SPANS + [("model", 120, 130)])
    found = program_spans.spans(_trace(SERVE_KERNELS))
    assert found["model"] == [(0.010, 0.060)]
    assert "copy_in" not in found
    assert sorted(program_spans.named(found, "encoder.")) == [(0.010, 0.015), (0.015, 0.025)]
    assert program_spans.named(found, "step") == []


def test_idle_inside_and_outside():
    trace = _trace([(0, 10, 20), (0, 30, 40)], window_ms=50)
    assert program_spans.idle_s(trace, [(0, 0.05)]) == pytest.approx(0.030)
    assert program_spans.idle_s(trace, [(0, 0.05)], [(0.015, 0.035)]) == pytest.approx(0.020)
    assert program_spans.idle_s(trace, [(0.045, 0.060)]) == pytest.approx(0.005)  # clipped


def test_trace_is_the_same_beside_the_ports_ranges():
    """The port's ranges are host ops named ``ltu.*``: the Trace the
    existing readers use takes nothing from them."""
    base = [_event("portbench.runner", 0, 100), _event("aten::conv3d", 11, 14),
            _event("aten::empty_strided", 46, 47), _event("Memcpy HtoD", 1, 3, CUDA, 99)]
    ranges = [_event("ltu." + name, s, t) for name, s, t in SERVE_SPANS]
    plain, beside = _trace(SERVE_KERNELS, extra=base), _trace(SERVE_KERNELS, extra=base + ranges)
    for field in ("kernels", "copies", "launches", "ops", "busy"):
        assert getattr(beside, field) == getattr(plain, field)
    assert dict(beside.spans) == dict(plain.spans) == {"runner": [(0.0, 0.1)]}
    assert beside.idle_gaps() == plain.idle_gaps()
    assert beside.busy_s() == plain.busy_s()
