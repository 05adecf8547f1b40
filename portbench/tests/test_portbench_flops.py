"""The configurations' frozen FLOPs and attention calls against the port's
own counter (``lintransunet_tpu_torch.experiments.roofline``: the plain
function on fake tensors), recomputed on the CPU."""

import pytest
import torch

from portbench import generate

CONFIGS = ("masktransunet-pancreas", "bottletransunet", "masktransunet-pancreas-fused")


def _model(config):
    from lintransunet_tpu_torch.models import Model_Dict

    cls = Model_Dict[config["model"]]
    return cls(**config["model_kwargs"], **config.get("program_kwargs", {}),
               dtype=torch.bfloat16, device="cpu", attention_impl="plain")


@pytest.mark.parametrize("name", CONFIGS)
def test_window_flops(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from lintransunet_tpu_torch.experiments import roofline

    config = generate.load_json("configs", name)
    model = _model(config).eval()
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = roofline.build_program("window", model, 4, window=(512, 512, 32))
        flops = roofline.program_cost(fn, *args).flops
    assert flops == 4 * config["flops"]["window"]


def test_train_step_flops():
    from lintransunet_tpu_torch.experiments import roofline

    config = generate.load_json("configs", "masktransunet-pancreas")
    assert roofline.count("step", 3).flops == config["flops"]["train_step"]


@pytest.mark.parametrize("name", CONFIGS)
def test_attention_calls(name, monkeypatch):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from lintransunet_tpu_torch.ops import linear_attention as la

    config = generate.load_json("configs", name)
    calls, real = [], la.linear_attention_qkv

    def record(qkv, heads):
        b, n, width = qkv.shape
        calls.append([b * heads, n, width // (3 * heads)])
        return real(qkv, heads)

    monkeypatch.setattr(la, "linear_attention_qkv", record)
    from lintransunet_tpu_torch.models import Model_Dict

    model = Model_Dict[config["model"]](**config["model_kwargs"],
                                        **config.get("program_kwargs", {}),
                                        dtype=torch.bfloat16, device="cpu").eval()
    for batch, key in ((1, "window"), (3, "train_step")):
        if key not in config["attention_calls"]:
            continue
        calls.clear()
        with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
            model(torch.randn(batch, 1, 512, 512, 32))
        assert calls == config["attention_calls"][key]
