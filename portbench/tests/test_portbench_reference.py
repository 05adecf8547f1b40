"""The plain reference against the port's path at a tiny size, on weights
the benchmark drew: the eval forward, three training micro-steps with
accumulation and dropout, and the block-wise batch of the data-parallel
reference against the whole batch."""

import pytest
import torch

from portbench import program
from portbench.reference import model as reference
from portbench.reference.train import Trainer
from portbench.tests import small


def _pair(name, seed=3):
    config = small.config(name)
    state = program.weights(config, seed, torch.device("cpu"))
    ref = reference.build(config)
    ref.load_state_dict(state)
    port = program.build_model(config, state, torch.device("cpu"))
    return config, state, ref, port


@pytest.mark.parametrize("name", ["masktransunet-pancreas", "bottletransunet"])
def test_eval_forward_matches_the_port(name):
    config, _, ref, port = _pair(name)
    x = torch.randn(2, 1, 64, 64, 8, generator=torch.Generator().manual_seed(1))
    ref.eval()
    port.eval()
    with torch.no_grad():
        out = ref(x)
        if config["eval_output"] == "one_hot":
            expect = port(x, return_aux=True)[0]
            out = torch.softmax(out, dim=1)
        else:
            expect = port(x)
    assert (out - expect).abs().max() < 1e-4


def test_weights_are_drawn_from_the_seed_with_the_flax_law():
    config = small.config("masktransunet-pancreas")
    a = program.weights(config, 5, torch.device("cpu"))
    b = program.weights(config, 5, torch.device("cpu"))
    c = program.weights(config, 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encode.input_block.weight"], c["encode.input_block.weight"])
    w = a["decode.final_block.weight"]
    fan_in = w[0].numel()
    assert w.abs().max() <= 2.0 / fan_in ** 0.5 / 0.8796 + 1e-6
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.1
    assert torch.all(a["decode.final_block.bias"] == 0)


def test_three_micro_steps_follow_the_port():
    from lintransunet_tpu_torch import engine
    from lintransunet_tpu_torch.cli.common import get_criterion_list

    config, state, ref, port = _pair("masktransunet-pancreas")
    traffic = small.train()
    criterions, _ = get_criterion_list(5, tuple(traffic["criteria"]))
    port_state = engine.create_train_state(port, 1e-4, step_times=2)
    step = engine.make_train_step(port, criterions)
    trainer = Trainer(ref, 1e-4, 2)
    weights = torch.tensor(traffic["level_weights"])
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    y = torch.zeros(2, 64, 64, 8, dtype=torch.long)
    y[:, 20:40, 24:36, 2:6] = 1
    for k in range(3):
        x = torch.randn(2, 1, 64, 64, 8, generator=torch.Generator().manual_seed(10 + k))
        a = step(port_state, x, y, weights, g1)[0].item()
        b = trainer.step(x, y, weights, g2).item()
        assert abs(a - b) <= 1e-5 * abs(b)
    params = dict(ref.named_parameters())
    moved = [n for n, p in port.named_parameters() if not torch.equal(p, state[n])]
    assert moved and all(not torch.equal(params[n], state[n]) for n in moved)


def test_block_wise_batch_is_the_whole_batch():
    config = small.config("masktransunet-pancreas")
    state = program.weights(config, 4, torch.device("cpu"))
    y = torch.zeros(4, 64, 64, 8, dtype=torch.long)
    y[:, 20:40, 24:36, 2:6] = 1
    x = torch.randn(4, 1, 64, 64, 8, generator=torch.Generator().manual_seed(2))
    weights = torch.tensor(small.train()["level_weights"])
    losses, grads = [], []
    for blocks in (1, 2):
        ref = reference.build(config)
        ref.load_state_dict(state)
        trainer = Trainer(ref, 1e-4, 2)
        losses.append(trainer.step(x, y, weights, torch.Generator().manual_seed(8),
                                   blocks=blocks).item())
        grads.append(torch.cat([a.reshape(-1) for a in trainer.acc]))
    assert losses[0] == pytest.approx(losses[1], rel=1e-5)
    assert (grads[0] - grads[1]).abs().max() <= 1e-4 * grads[0].abs().max()


def test_fp8_products_round_the_operands():
    x = torch.randn(64, 64)
    with reference.fp8_products():
        y = reference._operand(x)
    assert not torch.equal(x, y)
    assert (x - y).abs().max() <= 0.07 * x.abs().max()
    assert torch.equal(reference._operand(x), x)


def test_weight_overrides_set_the_mask_heads_background_prior():
    config = small.config("masktransunet-pancreas")
    state = program.weights(config, 5, torch.device("cpu"))
    heads = [k for k in state if k.startswith("decode.mask_conv_list_") and k.endswith(".bias")]
    assert len(heads) == 4
    assert all(state[k][0] == 8.0 and state[k][1] == 0.0 for k in heads)
    plain = dict(config, weight_overrides=[])
    other = program.weights(plain, 5, torch.device("cpu"))
    assert all(torch.equal(state[k], other[k]) for k in state if k not in heads)
