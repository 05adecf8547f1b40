"""A configuration's own reference module and build flags, on the CPU.

The two configurations that came before the hooks draw the same weights
and build the same reference classes; a configuration whose ``reference``
names a module builds from it, and an unknown module or model is refused;
``program_kwargs`` reach the port's model and not the reference; and the
fused configuration's frozen transformer-stack and conv-unit calls are what
the port's counter (``lintransunet_tpu_torch.experiments.roofline``) finds
on the plain path of one eval window."""

import hashlib
import sys
import types

import pytest
import torch
from torch import nn

from portbench import generate, program, roofline
from portbench.reference import model as reference
from portbench.tests import small

# sha256 over the sorted names and bytes of the state each configuration
# draws on the CPU from seed 2 ** 31 + 11, taken before the hooks existed
DRAWN = {"masktransunet-pancreas": ("MaskTransUnet", 600, 20822660,
                                    "4919e8e86cc24411cbd37472accb4668a7f11c5451298ac1e15d6f3079d39fa1"),
         "bottletransunet": ("BottleTransUnet", 102, 6234632,
                             "e1362a3b5a849847715958b9c358794ec4bc1b2e945c4a634a15f3480be94cd7")}
FUSED = "masktransunet-pancreas-fused"


@pytest.mark.parametrize("name", sorted(DRAWN))
def test_existing_configurations_draw_the_same_weights_and_reference(name):
    cls, leaves, numel, digest = DRAWN[name]
    config = generate.load_json("configs", name)
    assert "reference" not in config and "program_kwargs" not in config
    state = program.weights(config, 2 ** 31 + 11, torch.device("cpu"))
    h = hashlib.sha256()
    for key in sorted(state):
        h.update(key.encode())
        h.update(state[key].contiguous().numpy().tobytes())
    assert (len(state), sum(t.numel() for t in state.values()), h.hexdigest()) == (
        leaves, numel, digest)
    assert type(reference.build(config, device="meta")) is reference.MODELS[cls]


def test_the_fused_configuration_is_the_flagships_but_for_its_build_flags():
    plain, fused = (generate.load_json("configs", n) for n in ("masktransunet-pancreas", FUSED))
    assert fused["program_kwargs"] == {"fused_s1": True, "fused_stack": True}
    same = ("source", "model", "model_kwargs", "weight_overrides", "reduced", "compute_dtype",
            "parameter_dtype", "parameters", "eval_output")
    assert {k: fused[k] for k in same} == {k: plain[k] for k in same}
    assert fused["flops"]["window"] == plain["flops"]["window"]
    assert fused["attention_calls"] == {"window": []}
    a = program.weights(plain, 7, torch.device("cpu"))
    b = program.weights(fused, 7, torch.device("cpu"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


class _Tiny(nn.Module):
    """A reference kept in the test: one 1x1x1 convolution."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.proj = reference.Conv3d(1, channels, 1)

    def forward(self, x):
        return self.proj(x.to(self.dtype))


@pytest.fixture
def tiny_module(monkeypatch):
    module = types.ModuleType("portbench.reference.tiny_fixture")
    module.MODELS = {"Tiny": _Tiny}
    monkeypatch.setitem(sys.modules, module.__name__, module)
    return {"name": "tiny", "model": "Tiny", "model_kwargs": {"channels": 3},
            "reference": "tiny_fixture"}


def test_a_configuration_builds_from_its_own_reference_module(tiny_module):
    ref = reference.build(tiny_module, device="meta")
    assert type(ref) is _Tiny
    assert program.parameter_shapes(tiny_module) == [("proj.weight", (3, 1, 1, 1, 1)),
                                                     ("proj.bias", (3,))]
    state = program.weights(tiny_module, 5, torch.device("cpu"))
    assert state["proj.weight"].shape == (3, 1, 1, 1, 1) and torch.all(state["proj.bias"] == 0)


@pytest.mark.parametrize("change", [{"reference": "no_such_module"}, {"reference": "model.x"},
                                    {"model": "SkipTransUnet"}],
                         ids=["unknown_module", "not_a_name", "model_not_in_module"])
def test_an_unknown_reference_or_model_is_refused_by_name(tiny_module, change):
    config = dict(tiny_module, **change)
    with pytest.raises(ValueError, match="'tiny'"):
        reference.build(config, device="meta")
    with pytest.raises(ValueError, match="'tiny'"):
        program.parameter_shapes(config)


def test_a_model_the_default_reference_lacks_is_refused_by_name():
    config = dict(generate.load_json("configs", "bottletransunet"), model="SkipTransUnet")
    with pytest.raises(ValueError, match="'bottletransunet'.*SkipTransUnet"):
        reference.build(config, device="meta")


def test_a_build_flag_in_both_kwargs_is_refused():
    config = small.config(FUSED)
    config["model_kwargs"] = dict(config["model_kwargs"], fused_s1=True)
    state = program.weights(small.config(FUSED), 3, torch.device("cpu"))
    with pytest.raises(ValueError, match="fused_s1"):
        program.build_model(config, state, torch.device("cpu"))


# The fused build against the f32 reference at a small width, on the plain
# CPU paths of the conv unit and the stack. The conv unit rounds its
# operands to bf16 even in an f32 model, as the JAX package's does, so the
# class probabilities move by bf16 roundings: over seeds 0-7 the largest
# gap read 0.023-0.034 and the mean 0.0024-0.0031, where the unfused build
# stays under 1e-4 and the stack left out reads 0.69-0.83 and 0.116-0.127.
FUSED_MAX, FUSED_MEAN = 0.06, 0.006


def test_build_flags_reach_the_port_and_not_the_reference():
    config = small.config(FUSED)
    state = program.weights(config, 3, torch.device("cpu"))
    port = program.build_model(config, state, torch.device("cpu"))
    assert port.fused_s1 and port.fused_stack and not port.training
    ref = reference.build(config)  # a flag it received would raise TypeError
    ref.load_state_dict(state)
    ref.eval()
    plain = program.build_model(dict(config, program_kwargs={}), state, torch.device("cpu"))
    assert not plain.fused_s1 and not plain.fused_stack
    x = torch.randn(2, 1, 64, 64, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        expect = ref(x)
        got = port.eval()(x, return_aux=True)[0]
        unfused = plain.eval()(x, return_aux=True)[0]
    expect = torch.softmax(expect, dim=1)
    gap = (got - expect).abs()
    assert gap.max().item() <= FUSED_MAX and gap.mean().item() <= FUSED_MEAN
    assert (unfused - expect).abs().max().item() < 1e-4
    assert (got - unfused).abs().max().item() > 0  # the fused paths ran


def fused_calls(config: dict, window=(512, 512, 32)):
    """(stack calls, conv-unit calls) of one eval window (batch 1) of the
    configuration's port model, on fake tensors through the plain versions
    of both ops, each with its shape and the FLOPs the port's counter
    (``experiments.roofline.program_cost``) gives the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from lintransunet_tpu_torch.experiments import roofline as counter
    from lintransunet_tpu_torch.models import Model_Dict
    from lintransunet_tpu_torch.ops import conv_unit, fused_stack

    stacks, convs = [], []
    real_stack, real_conv = fused_stack.fused_transformer_stack, conv_unit.conv_unit

    def stack(x, A, w2, vecs, n_heads):
        b, n, c = x.shape
        flops = counter.program_cost(fused_stack.fused_transformer_stack_reference,
                                     x, A, w2, vecs, n_heads).flops
        stacks.append({"tokens": [b, n, c], "layers": A.shape[0], "heads": n_heads,
                       "flops": flops,
                       "bytes": roofline.stack_bytes(b, n, c, A.shape[0], x.element_size())})
        return real_stack(x, A, w2, vecs, n_heads)

    def conv(xa, wa, xb=None, wb=None, bias=None, affine_a=None, affine_b=None, **kw):
        args = (xa, wa, xb, wb, bias, affine_a, affine_b)
        flops = counter.program_cost(lambda *a: conv_unit.conv_unit_reference(*a, **kw),
                                     *args).flops
        n, ca, *size = xa.shape
        cb = 0 if xb is None else xb.shape[1]
        out = wa.shape[0]
        affine = (ca if affine_a is not None else 0) + (cb if affine_b is not None else 0)
        voxels = size[0] * size[1] * size[2]
        convs.append({"n": n, "in": [ca, cb], "out": out, "size": size, "affine": affine,
                      "flops": flops,
                      "bytes": roofline.conv_unit_bytes(n, ca, cb, out, voxels, affine,
                                                        xa.element_size())})
        return real_conv(xa, wa, xb, wb, bias, affine_a, affine_b, **kw)

    model = Model_Dict[config["model"]](**config["model_kwargs"], **config["program_kwargs"],
                                        dtype=program.COMPUTE_DTYPES[config["compute_dtype"]],
                                        device="cpu")
    saved = fused_stack.fused_transformer_stack, conv_unit.conv_unit
    fused_stack.fused_transformer_stack, conv_unit.conv_unit = stack, conv
    try:
        with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
            fn, args = counter.build_program("window", model.eval(), 1, window=window)
            fn(*args)
    finally:
        fused_stack.fused_transformer_stack, conv_unit.conv_unit = saved
    return stacks, convs


@pytest.fixture(scope="module")
def counted():
    return fused_calls(generate.load_json("configs", FUSED))


def test_fused_window_calls_are_the_frozen_lists(counted):
    config = generate.load_json("configs", FUSED)
    stacks, convs = counted
    assert stacks == config["stack_calls"]["window"]
    assert convs == config["conv_unit_calls"]["window"]


def test_frozen_calls_follow_the_benchmarks_own_formulas(counted):
    stacks, convs = counted
    assert len(stacks) == 8 and len(convs) == 7
    for c in stacks:
        b, n, width = c["tokens"]
        assert c["flops"] == roofline.stack_flops(b, n, width, c["layers"], c["heads"])
    for c in convs:
        voxels = c["size"][0] * c["size"][1] * c["size"][2]
        assert c["flops"] == roofline.conv_unit_flops(c["n"], *c["in"], c["out"], voxels)
    # the bounds a window's calls add up to (PERF.md's kernel table: the
    # stack's 8 calls 0.166 ms at a 64-deep window, the conv unit's 7 0.664 ms)
    assert roofline.calls_bound_s(stacks) * 1e3 == pytest.approx(0.166 / 2, rel=0.05)
    assert roofline.calls_bound_s(convs) * 1e3 == pytest.approx(0.664 / 2, rel=0.05)
