"""The control on the card: the reference one precision below the
configuration's (fp8 products, bf16 elsewhere) put in the program's place
comes out not correct against each serving cell's limit, at the cell's own
size (one seed; ``python3 -m portbench.readings`` reads three or more).
Run on the card: ``python -m pytest -q portbench/tests -m cuda``."""

import pytest
import torch

from portbench import check, generate, harness, readings

CELLS = {c["name"]: c for c in harness.manifest()["workloads"]}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's size on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["flagship-serve", "flagship-serve-fused", "bottle-serve"])
def test_serving_control_is_not_correct(cell):
    dev = _card()
    c = CELLS[cell]
    config = generate.load_json("configs", c["config"])
    traffic = generate.load_json("traffic", c["traffic"])
    values = readings.serve(config, traffic, 2 ** 31 + 77, dev)["control"]
    correct, checks = check.judge(values, cell)
    assert not correct, checks


@pytest.mark.cuda
def test_training_control_and_half_batch_are_not_correct():
    dev = _card()
    c = CELLS["flagship-train"]
    config = generate.load_json("configs", c["config"])
    traffic = generate.load_json("traffic", c["traffic"])
    out = readings.train(config, traffic, 2 ** 31 + 78, dev)
    for fault in ("control", "half_batch"):
        correct, checks = check.judge(out[fault], c["name"])
        assert not correct, (fault, checks)
