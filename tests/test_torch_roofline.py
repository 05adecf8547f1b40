"""The port's floors (``experiments/roofline.py``, ``experiments/stage_flops.py``)
at SMALL, on the CPU.

* The FLOPs that ``program_cost`` counts on fake tensors (FlopCounterMode
  over the plain path) equal an independent count from the modules' shapes,
  recorded by forward hooks on a real run: 2 (C_in / groups) k^3 C_out per
  output voxel of each ``Conv3d``, 2 in out per token of each ``Linear``
  called as a module and of each self-attention's one QKV product (C to
  3C), 4 BH N d^2 per linear-attention call (k^T v, then q against the
  context),
  and each ROI bridge's four warp products (contracting H, then W, of its
  input, and back from the crop). The step (forward, backward, AdamW) adds
  twice each product's forward FLOPs for its backward (the input's and the
  weight's gradients; the attention's two matmuls' operands), once where
  only one operand has a gradient: the input conv (its input is data) and
  the warps (their tent weights come from the box, no gradient). Both
  counts are integers and must be equal.
* Fake tensors count what real ones count; the fused configuration the
  default's FLOPs; a batch of 2 exactly twice a batch of 1's.
* The port's conv and product FLOPs equal those of the JAX package's SMALL
  eval forward at ``packed_levels=0``, counted from its jaxpr's
  ``conv_general_dilated`` and ``dot_general`` equations, nested jaxprs
  included (on the CPU JAX's attention takes its plain einsums). One op is a
  product in one package only: JAX's trilinear align-corners resize
  (``ops/resample.resize_linear_align_corners``, one matmul an axis) is
  ``F.interpolate`` in the port. It is 1.05% of JAX's count here, and held
  exactly: JAX's convs equal the port's, JAX's products less the resize's
  equal the port's mm, addmm and bmm, tolerance 0.
* ``stage_flops`` splits the window's count into stages that sum to it, in
  FLOPs and both byte terms.
* Timing needs a card: ``--time`` and the timers raise without one.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import source_info_util
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from lintransunet_tpu.engine import make_eval_forward as jax_eval_forward
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu_torch.experiments import roofline, stage_flops
from lintransunet_tpu_torch.models import MultiheadLinearAttention
from lintransunet_tpu_torch.models.bridges import ROIBridge
from torch_port_helpers import SMALL, random_params

torch.set_num_threads(2)

CONFIG = {k: SMALL[k] for k in ("num_layers", "roi_size_list", "is_roi_list")}
GEOMETRY = dict(window=(64, 64, 16), patch=(64, 64, 16))
JAX_RESIZE = "resize_linear_align_corners"


def _count(program, batch=1):
    return roofline.count(program, batch, config=CONFIG, **GEOMETRY)


@pytest.fixture(scope="module")
def window_cost():
    return _count("window")


def _prod(shape):
    return int(np.prod(shape))


def analytic_flops(program):
    """The program's FLOPs from the shapes its modules see on one real run
    of the plain SMALL model (its forward; for "step" the forward of a
    train step, with the backward by the rules of the module docstring)."""
    model = roofline.build_model(program, **CONFIG)
    records = []  # (a product's forward FLOPs, times it runs forward and backward)

    def conv(m, args, out):
        per = 2 * _prod(m.weight.shape[1:]) * out.numel()
        records.append((per, 2 if args[0].requires_grad else 1))

    def linear(m, args, out):
        tokens = args[0].numel() // m.in_features
        records.append((2 * tokens * m.in_features * m.out_features, 2))

    def attention(m, args, out):
        b, n, c = args[0].shape
        d = c // m.nhead
        records.append((2 * b * n * c * 3 * c, 2))  # the one QKV product (C -> 3C)
        records.append((4 * b * m.nhead * n * d * d, 2))

    def bridge(m, args, out):
        n, c, h, w, d = args[0].shape
        inner = crops[m]
        oh, ow = inner["in"][2:4]
        rh, rw = inner["out"][2:4]
        warps = 2 * n * c * d * (oh * w * h + oh * ow * w + h * rw * rh + h * w * rw)
        records.append((warps, 1))

    crops = {}

    def crop(owner):
        def hook(m, args, out):
            crops[owner] = {"in": tuple(args[0].shape), "out": tuple(out.shape)}
        return hook

    handles = []
    for m in model.modules():
        if isinstance(m, nn.Conv3d):
            handles.append(m.register_forward_hook(conv))
        elif isinstance(m, nn.Linear):
            handles.append(m.register_forward_hook(linear))
        elif isinstance(m, MultiheadLinearAttention):
            handles.append(m.register_forward_hook(attention))
        elif isinstance(m, ROIBridge):
            handles.append(m.transformer.register_forward_hook(crop(m)))
            handles.append(m.register_forward_hook(bridge))
    fn, args = roofline.build_program(program, model, 1, **GEOMETRY,
                                      generator=torch.Generator().manual_seed(0))
    fn(*args)
    for h in handles:
        h.remove()
    forward = sum(per for per, _ in records)
    backward = sum(per * times for per, times in records) if program == "step" else 0
    return forward + backward


@pytest.mark.parametrize("program", ["window", "step"])
def test_flops_equal_the_analytic_count(program, window_cost):
    cost = window_cost if program == "window" else _count("step")
    want = analytic_flops(program)
    assert isinstance(cost.flops, int) and isinstance(want, int)
    assert cost.flops == want
    assert cost.bytes_fused > 0 and cost.bytes_eager > cost.bytes_fused


def test_fake_tensors_count_what_real_ones_count(window_cost):
    model = roofline.build_model("window", **CONFIG)
    fn, args = roofline.build_program("window", model, 1, **GEOMETRY,
                                      generator=torch.Generator().manual_seed(0))
    real = roofline.program_cost(fn, *args)
    assert (real.flops, real.bytes_fused, real.bytes_eager) == (
        window_cost.flops, window_cost.bytes_fused, window_cost.bytes_eager)
    assert real.per_module.keys() == window_cost.per_module.keys()


def test_fused_configuration_counts_the_default_flops(window_cost):
    fused = _count("fused")
    assert fused.flops == window_cost.flops
    assert fused.bytes_fused > 0


def test_batch_of_two_is_twice_the_flops(window_cost):
    assert _count("window", 2).flops == 2 * window_cost.flops


def _jax_products():
    """{("conv" or "dot", function name): FLOPs} of JAX's SMALL eval forward
    at packed_levels=0, from its jaxpr, nested jaxprs included."""
    model = JaxMaskTransUnet(**SMALL, packed_levels=0)
    x = jnp.zeros((1,) + GEOMETRY["window"] + (1,), jnp.float32)
    params = random_params(model, x, train=False)
    jaxpr = jax.make_jaxpr(jax_eval_forward(model))(params, x).jaxpr
    counts = collections.Counter()

    def walk(jp, times):
        for eqn in jp.eqns:
            frame = source_info_util.user_frame(eqn.source_info.traceback)
            where = frame.function_name if frame else ""
            out = _prod(eqn.outvars[0].aval.shape) if eqn.outvars else 0
            if eqn.primitive.name == "conv_general_dilated":
                spec = eqn.params["dimension_numbers"].rhs_spec
                rhs = eqn.invars[1].aval.shape
                counts["conv", where] += times * 2 * out * rhs[spec[1]] * _prod(
                    [rhs[i] for i in spec[2:]])
            elif eqn.primitive.name == "dot_general":
                (contract, _), _ = eqn.params["dimension_numbers"]
                lhs = eqn.invars[0].aval.shape
                counts["dot", where] += times * 2 * out * _prod([lhs[i] for i in contract])
            inner = times * (eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1)
            for value in eqn.params.values():
                for sub in value if isinstance(value, (list, tuple)) else [value]:
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr, inner)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub, inner)

    walk(jaxpr, 1)
    return counts


def test_products_equal_jax_jaxpr():
    model = roofline.build_model("window", dtype=torch.float32, **CONFIG)
    fn, args = roofline.build_program("window", model, 1, **GEOMETRY,
                                      generator=torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    port = {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}
    assert set(port) == {"aten.convolution", "aten.addmm", "aten.bmm"}

    jax_counts = _jax_products()
    conv = sum(v for (kind, _), v in jax_counts.items() if kind == "conv")
    dots = sum(v for (kind, _), v in jax_counts.items() if kind == "dot")
    resize = sum(v for (kind, where), v in jax_counts.items()
                 if kind == "dot" and JAX_RESIZE in where)
    # the one product of one package only, and its share of JAX's count
    assert resize > 0
    assert 0.0104 < resize / (conv + dots) < 0.0106
    assert port["aten.convolution"] == conv
    assert port["aten.addmm"] + port["aten.bmm"] == dots - resize


def test_stages_sum_to_the_window(window_cost):
    rows = stage_flops.stage_costs(window_cost, roofline.build_model("window", **CONFIG))
    labels = [label for label, _ in rows]
    assert "decode.bridge_list_4" in labels and "decode.final_block" in labels
    assert sum(labels.count(f"decode.bridge_list_{i}") for i in range(1, 4)) == 3
    total = roofline.ZERO
    for _, cost in rows:
        assert min(cost.flops, cost.bytes_fused, cost.bytes_eager) >= 0
        total = total + cost
    assert (total.flops, total.bytes_fused, total.bytes_eager) == (
        window_cost.flops, window_cost.bytes_fused, window_cost.bytes_eager)
    bridge = dict(rows)["decode.bridge_list_2"]
    assert bridge.flops == window_cost.per_module["MaskTransUnet.decode.bridge_list_2"].flops > 0


def test_timing_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.main(["--time"])
    with pytest.raises(RuntimeError, match="CUDA"):
        stage_flops.main(["--time"])
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.time_program(lambda: None, ())
