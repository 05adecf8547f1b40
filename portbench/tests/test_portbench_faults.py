"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the loops run on the CPU at a
tiny size, once sound and once for each fault the cell can have."""

import json

import pytest
import torch

from portbench import harness, program
from portbench.loops import train, worklist
from portbench.tests import small

BENCH = harness.manifest()
CELLS = {c["name"]: c for c in BENCH["workloads"]}


def _result(capfd):
    lines = [l for l in capfd.readouterr().out.splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def _serve(cell, capfd):
    c = CELLS[cell]
    assert worklist.run(small.args(), BENCH, c, small.config(c["config"]), small.worklist(),
                        0.0, device="cpu") == 0
    return _result(capfd)


def _train(cell, capfd, traffic=None):
    c = CELLS[cell]
    assert train.run(small.args(), BENCH, c, small.config(c["config"]),
                     traffic or small.train(c["traffic"]), 0.0, device="cpu") == 0
    return _result(capfd)


@pytest.mark.parametrize("cell", ["flagship-serve", "flagship-serve-fused", "bottle-serve"])
def test_serving_sound_and_with_an_answer_altered(cell, capfd, monkeypatch):
    assert _serve(cell, capfd)["correct"] is True
    real = program.eval_runner

    def altered(model, traffic):
        runner = real(model, traffic)

        def run(volume):
            out = runner(volume).clone()
            out[..., :4] = 1.0 - out[..., :4]  # the first slices' answers flipped
            return out
        return run

    monkeypatch.setattr(program, "eval_runner", altered)
    result = _serve(cell, capfd)
    assert result["correct"] is False
    assert result["checks"]["wrong_side_median"]["value"] > result["checks"]["wrong_side_median"]["limit"]


def _broken_step(monkeypatch, broken):
    real = program.train_step

    def train_step(model, traffic, mesh=None):
        state, step = real(model, traffic, mesh)
        return state, broken(step)

    monkeypatch.setattr(program, "train_step", train_step)


def test_training_sound(capfd):
    assert _train("flagship-train", capfd)["correct"] is True


def test_training_state_unchanged(capfd, monkeypatch):
    def broken(step):
        def run(state, images, labels, weights, generator=None):
            loss, logs = step.loss_fn(images, labels, weights, generator)
            return loss.detach(), logs
        return run

    _broken_step(monkeypatch, broken)
    result = _train("flagship-train", capfd)
    assert result["correct"] is False
    assert result["checks"]["change_worst"]["value"] == pytest.approx(1.0)


def test_training_half_batch_left_out(capfd, monkeypatch):
    def broken(step):
        def run(state, images, labels, weights, generator=None):
            keep = images.shape[0] - images.shape[0] // 2
            return step(state, images[:keep], labels[:keep], weights, generator)
        return run

    _broken_step(monkeypatch, broken)
    assert _train("flagship-train", capfd)["correct"] is False


DATA_PARALLEL = """
import json, sys
sys.path.insert(0, {root!r})
import torch.multiprocessing as mp
from portbench import harness
from portbench.loops import train
from portbench.tests import small
real = mp.get_context
train.mp.get_context = lambda method: real("fork")  # the ranks inherit what is planted
if {broken}:
    from lintransunet_tpu_torch import parallel
    parallel.all_reduce_mean = lambda mesh, tensors: tensors
bench = harness.manifest()
cell = {{c["name"]: c for c in bench["workloads"]}}["flagship-train-dp4"]
traffic = small.train(cell["traffic"])
traffic["ranks"] = 2
sys.exit(train.run(small.args(), bench, cell, small.config(cell["config"]), traffic, 0.0,
                   device="cpu"))
"""


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "no_exchange"])
def test_data_parallel_sound_and_without_the_exchange(broken):
    import os
    import subprocess
    import sys

    root = os.path.dirname(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", DATA_PARALLEL.format(root=root, broken=broken)],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads([l for l in out.stdout.splitlines() if l.startswith("{")][-1])
    assert result["correct"] is (not broken)
