"""The port's profiler spans (``lintransunet_tpu_torch.utils.profiling.span``):
none while no profiler records, and under ``torch.profiler`` the runner's,
the models' and the train step's stages as ``ltu.*`` ranges with their
nesting, every op of a forward in exactly one stage. CPU, torch only."""

import os

import pytest
import torch
import torch.multiprocessing as mp
from torch.profiler import ProfilerActivity, profile

import torch_port_helpers as helpers
from lintransunet_tpu_torch import engine
from lintransunet_tpu_torch.cli.common import EvalConfig, get_criterion_list, make_eval_runner
from lintransunet_tpu_torch.engine.sliding_window import dense_window_starts
from lintransunet_tpu_torch.models import Model_Dict
from lintransunet_tpu_torch.utils import profiling

SMALL = dict(num_layers=(8, 16, 32, 32, 64), dim_input=1, dim_output=2)
MASK = dict(SMALL, roi_size_list=(16, 12, 8, 6, 4), is_roi_list=(False, True, True, True, True),
            n_layers=1)
WINDOW = EvalConfig(roi_size=64, depth_size=8, overlap=0.6, mode="constant")
VOLUME = (1, 1, 64, 64, 12)  # three windows in depth
LEVELS = len(SMALL["num_layers"])
ENCODER = {"encoder.embed"} | {f"encoder.level{i}" for i in range(1, LEVELS)}
DECODER = {f"decoder.level{i}" for i in range(LEVELS - 1)} | {"decoder.head"}
ROI_BRIDGES = {f"bridge.level{i}" for i in range(1, LEVELS - 1)}
BOTTLENECK = {f"bridge.level{LEVELS - 1}"}
RUNNER = {"runner", "runner.gather", "runner.blend", "runner.normalise", "runner.finish"}
STEP = {"step", "step.forward", "step.backward", "step.update", "update.accumulate",
        "update.optimizer"}
STAGES = ("encoder.", "bridge.", "decoder.")


def _model(name, seed=0):
    torch.manual_seed(seed)
    kwargs = MASK if name == "MaskTransUnet" else SMALL
    return Model_Dict[name](**kwargs, device="cpu")


def _events(prof):
    """(ltu ranges, aten ops): (name without the prefix / op name, start,
    end, thread) of the profiler's host events."""
    spans, ops = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        row = (name, e.start_ns(), e.end_ns(), e.start_thread_id())
        if name.startswith(profiling.PREFIX):
            spans.append((name[len(profiling.PREFIX):],) + row[1:])
        elif name.startswith("aten::"):
            ops.append(row)
    return spans, ops


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2] and inner[3] == outer[3]


def _nested(spans, child, parent):
    """Every span named ``child`` (or starting with it, if it ends in a dot)
    lies inside a ``parent`` span."""
    kids = [s for s in spans if s[0] == child or (child.endswith(".") and s[0].startswith(child))]
    assert kids, child
    for kid in kids:
        assert any(_inside(kid, p) for p in spans if p[0] == parent), (kid, parent)


def _each_op_in_one_stage(spans, ops):
    """Every ATen op inside a ``model`` span lies in exactly one stage span,
    a bridge nested in a decoder level read as the bridge's."""
    stages = [s for s in spans if s[0].startswith(STAGES)]
    checked = 0
    for model in (s for s in spans if s[0] == "model"):
        for op in (o for o in ops if _inside(o, model)):
            around = [s for s in stages if _inside(op, s)]
            bridges = [s for s in around if s[0].startswith("bridge.")]
            around = [s for s in around if not (s[0].startswith("decoder.")
                                                and any(_inside(b, s) for b in bridges))]
            assert len(around) == 1, (op, around)
            checked += 1
    assert checked > 50


def _serve(model_name):
    model = _model(model_name)
    _, runner = make_eval_runner(model, WINDOW, sw_batch_size=1)
    return runner, torch.randn(VOLUME, generator=torch.Generator().manual_seed(1))


def _micro_step():
    """A ``step`` of the tiny flagship at step_times 2 and its inputs."""
    model = _model("MaskTransUnet").train()
    criterions, _ = get_criterion_list(LEVELS, ("CrossEntroLoss", "DiceClassLoss"))
    step = engine.make_train_step(model, criterions)
    state = engine.create_train_state(model, 1e-4, step_times=2)
    images = torch.randn(2, 1, 64, 64, 8, generator=torch.Generator().manual_seed(2))
    labels = torch.zeros(2, 64, 64, 8, dtype=torch.long)
    labels[:, 20:40, 24:36, 2:6] = 1
    return lambda: step(state, images, labels, torch.ones(LEVELS))


class _Counting:
    """A stand-in for the profiler range's constructor that counts its calls."""

    made = 0

    def __init__(self, *args, **kwargs):
        type(self).made += 1
        self._range = torch.profiler.record_function(args[0])

    def __enter__(self):
        return self._range.__enter__()

    def __exit__(self, *exc):
        return self._range.__exit__(*exc)


def test_no_range_is_made_while_no_profiler_records(monkeypatch):
    monkeypatch.setattr(_Counting, "made", 0)
    monkeypatch.setattr(profiling, "_Range", _Counting)
    runner, volume = _serve("MaskTransUnet")
    micro_step = _micro_step()
    kept = len(profiling.recorded())
    runner(volume)
    micro_step()
    assert _Counting.made == 0
    assert len(profiling.recorded()) == kept
    with profile(activities=[ProfilerActivity.CPU]):
        micro_step()
    assert _Counting.made >= len(STEP) - 1 + 10  # the patched constructor is the one used


@pytest.mark.parametrize("model_name", ["MaskTransUnet", "BottleTransUnet"])
def test_runner_spans_and_their_nesting(model_name):
    runner, volume = _serve(model_name)
    runner(volume)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner(volume)
    spans, ops = _events(prof)
    bridges = BOTTLENECK | (ROI_BRIDGES if model_name == "MaskTransUnet" else set())
    assert {s[0] for s in spans} == RUNNER | {"model"} | ENCODER | DECODER | bridges
    assert sum(s[0] == "runner" for s in spans) == 1
    windows = len(dense_window_starts(VOLUME[2:], (64, 64, 8), WINDOW.overlap))
    assert sum(s[0] == "model" for s in spans) == windows  # a forward a window
    for child in ("runner.gather", "runner.blend", "runner.normalise", "runner.finish", "model"):
        _nested(spans, child, "runner")
    for child in STAGES:
        _nested(spans, child, "model")
    for name in ROI_BRIDGES & bridges:
        _nested(spans, name, "decoder.level" + name[len("bridge.level"):])
    _each_op_in_one_stage(spans, ops)


@pytest.mark.parametrize("model_name", sorted(Model_Dict))
@pytest.mark.parametrize("train", [False, True])
def test_each_op_of_a_forward_lies_in_one_stage(model_name, train):
    model = _model(model_name).train(train)
    x = torch.randn(1, 1, 64, 64, 8, generator=torch.Generator().manual_seed(3))
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(x)
    spans, ops = _events(prof)
    assert sum(s[0] == "model" for s in spans) == 1
    assert ENCODER | DECODER <= {s[0] for s in spans}
    _each_op_in_one_stage(spans, ops)


def test_micro_step_spans_and_their_nesting():
    micro_step = _micro_step()
    micro_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        micro_step()  # the second of two: the optimizer runs
        micro_step()
    spans, ops = _events(prof)
    names = [s[0] for s in spans]
    assert set(names) == STEP | {"model"} | ENCODER | DECODER | ROI_BRIDGES | BOTTLENECK
    assert names.count("step") == 2 and names.count("update.optimizer") == 1
    for child in ("step.forward", "step.backward", "step.update"):
        _nested(spans, child, "step")
    for child in ("update.accumulate", "update.optimizer"):
        _nested(spans, child, "step.update")
    _nested(spans, "model", "step.forward")
    _each_op_in_one_stage(spans, ops)


def test_top_spans_carry_their_sequence_number():
    runner, volume = _serve("BottleTransUnet")
    micro_step = _micro_step()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        runner(volume)
        runner(volume)
        micro_step()
        micro_step()
    seq = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in ("ltu.runner", "ltu.step"):
            seq.setdefault(e.name(), []).append(e.kwinputs().get("seq"))
    assert seq["ltu.step"] == [0, 1]
    first, second = seq["ltu.runner"]
    assert second == first + 1


def test_ranges_are_host_ops_and_recorded_on_the_same_clock():
    """A span is an ordinary op to the profiler, not a user annotation, so
    the card's timeline gets no shadow of it; ``recorded()`` keeps its
    bounds on the clock of the profiler's timestamps."""
    runner, volume = _serve("BottleTransUnet")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner(volume)
    ranges = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.PREFIX)]
    assert ranges and not any(e.is_user_annotation() for e in ranges)
    recorded = profiling.recorded()[-len(ranges):]
    assert sorted(r[0] for r in recorded) == sorted(e.name()[len(profiling.PREFIX):]
                                                    for e in ranges)
    by_name = {}
    for e in ranges:
        by_name.setdefault(e.name()[len(profiling.PREFIX):], []).append(e)
    for name, start, end in recorded:
        assert any(abs(start - e.start_ns()) < 1e6 and abs(end - e.end_ns()) < 1e6
                   for e in by_name[name]), name


def test_dp_step_has_its_allreduce_span(tmp_path):
    workdir = str(tmp_path)
    mp.spawn(helpers.tracing_worker, args=(2, os.path.join(workdir, "store"), workdir),
             nprocs=2, join=True)
    for rank in range(2):
        spans = [(name[len(profiling.PREFIX):], s, t, 0) for name, s, t in
                 torch.load(os.path.join(workdir, f"spans{rank}.pt"))]
        names = [s[0] for s in spans]
        assert names.count("step.allreduce") == 1
        _nested(spans, "step.allreduce", "step")
        at = {s[0]: s for s in spans}
        assert at["step.backward"][2] <= at["step.allreduce"][1]
        assert at["step.allreduce"][2] <= at["step.update"][1]
