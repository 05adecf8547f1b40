"""The readers of the graphed train step (``graphed_steps_pct.train``,
``wgrad_unit_ms.train``) on synthetic traces with known answers, and their
silence on a port without the replay span or the kernel."""

import types

import pytest

from portbench import trace as tracing
from portbench.tests.test_portbench_program_spans import (
    CUDA, MS, START, _ctx, _event, _reader, _spans, _trace)
from lintransunet_tpu_torch.utils import profiling

# three traced micro-steps: two replayed, one eager; kernels launched in each
STEPS = [("step", 0, 30), ("step.replay", 1, 2), ("step", 30, 60), ("step.replay", 31, 32),
         ("step", 60, 90), ("step.forward", 61, 80)]
KERNELS = [(1.5, 2, 20), (31.5, 32, 50), (62, 63, 70)]


def test_graphed_share_on_a_known_trace(monkeypatch):
    _spans(monkeypatch, STEPS)
    read = _reader("graphed_steps_pct.train")
    assert read(_ctx("train", _trace(KERNELS))) == pytest.approx(200 / 3)
    assert read(_ctx("serve", _trace(KERNELS))) is None


def test_graphed_share_reads_nothing_without_a_replay(monkeypatch):
    read = _reader("graphed_steps_pct.train")
    _spans(monkeypatch, [s for s in STEPS if s[0] != "step.replay"])
    assert read(_ctx("train", _trace(KERNELS))) is None
    monkeypatch.delattr(profiling, "recorded")  # a port without the spans
    assert read(_ctx("train", _trace(KERNELS))) is None


def _named_trace(names):
    """A Trace of one kernel a name, each 1 ms, all linked."""
    events = []
    for corr, name in enumerate(names, 1):
        events.append(_event("cudaGraphLaunch", corr, corr + 0.01, corr=corr))
        events.append(_event(name, corr, corr + 1, CUDA, corr))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    return tracing.Trace(prof, START, START + 100 * MS)


def test_wgrad_unit_ms_on_a_known_trace():
    read = _reader("wgrad_unit_ms.train")
    trace = _named_trace(["void (anonymous namespace)::conv_unit_wgrad_dw(...)",
                          "void (anonymous namespace)::conv_unit_wgrad_sum(...)",
                          "void cudnn::cnn::convolveNd_wgrad_engine<...>", "void other"])
    assert read(_ctx("train", trace)) == pytest.approx(2 / 2)
    assert read(_ctx("serve", trace)) is None
    assert read(_ctx("train", _named_trace(["void cudnn::cnn::convolveNd_wgrad_engine<...>"]))) \
        is None
