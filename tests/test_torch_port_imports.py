"""The PyTorch port and ``chip_smoke.py`` never import jax, and the port's
CUDA wrappers keep CPU tensors on their plain paths without counting a
launch."""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lintransunet_tpu_torch import kernels
from lintransunet_tpu_torch.experiments import (
    conv_prototype,
    conv_retired,
    dot_probe,
    in_stats_probe,
    inner_probe,
    rowoffset_probe,
)
from lintransunet_tpu_torch.ops import conv_unit as cu
from lintransunet_tpu_torch.ops import fused_stack as fs
from lintransunet_tpu_torch.ops import linear_attention as fused

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import lintransunet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'lintransunet_tpu_torch.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'lintransunet_tpu.')))\n"
        "print(len(names), bad, sorted(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    count, rest = proc.stdout.split(" ", 1)
    bad, names = rest.split("] ", 1)
    assert int(count) >= 36  # every subpackage and module was imported
    assert bad.strip() == "["
    for name in ("losses", "losses.binary", "losses.functional", "ops.pool",
                 "engine.train", "engine.schedule", "engine.checkpoint", "cli.common",
                 "experiments", "experiments.common", "experiments.dot_probe",
                 "experiments.rowoffset_probe", "experiments.inner_probe",
                 "experiments.conv_prototype", "experiments.conv_retired",
                 "experiments.in_stats_probe"):
        assert f"'lintransunet_tpu_torch.{name}'" in names, name


def test_build_hash_covers_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh gives every library a new name, so a stale
    build is never loaded."""
    build = importlib.import_module("lintransunet_tpu_torch.kernels.build")

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.iterdir():
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build._library_path(name) for name in build.SIGNATURES}
    header = csrc / "common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build._library_path(name) for name in build.SIGNATURES}
    assert all(before[name] != after[name] for name in build.SIGNATURES)


def test_every_kernel_source_has_a_binding():
    sources = {p.stem for p in (REPO / "lintransunet_tpu_torch" / "csrc").glob("*.cu")}
    assert sources == set(kernels.SIGNATURES) == {
        "linear_attention", "conv_unit", "fused_stack", "probe_taps", "probe_conv",
        "probe_stats"}


def test_cpu_tensor_takes_plain_path_without_counting():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 33, 32)).astype(np.float32))
               for _ in range(3))
    before = fused.linear_attention.launches
    got = fused.linear_attention(q, k, v)
    assert fused.linear_attention.launches == before
    torch.testing.assert_close(got, fused.linear_attention_reference(q, k, v),
                               rtol=0, atol=0)
    bf = fused.linear_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert bf.dtype == torch.bfloat16 and fused.linear_attention.launches == before


def test_new_wrappers_take_plain_path_on_cpu_without_counting():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 3, 4, 5, 6)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 3, 3, 3, 3)).astype(np.float32))
    before = cu.conv_unit.launches
    y, stats = cu.conv_unit(x, w)
    assert cu.conv_unit.launches == before
    # operands rounded to bf16 by default, as JAX's fused_s1_canvas does
    rounded = [a.bfloat16().float() for a in (x, w)]
    torch.testing.assert_close(y, torch.nn.functional.conv3d(*rounded, padding=1))
    assert stats.shape == (1, 2, 2)
    tokens = torch.from_numpy(rng.standard_normal((1, 7, 32)).astype(np.float32))
    A, w2 = torch.zeros((1, 32, 192)), torch.zeros((1, 64, 32))
    vecs = torch.zeros((1, 16, 64))
    before = fs.fused_transformer_stack.launches
    out = fs.fused_transformer_stack(tokens, A, w2, vecs, 1)
    assert fs.fused_transformer_stack.launches == before
    assert out.shape == tokens.shape and torch.isfinite(out).all()


def _conv_args(**change):
    x = torch.zeros((1, 4, 6, 6, 6))
    w = torch.zeros((8, 4, 3, 3, 3))
    args = dict(xa=x, wa=w, xb=None, wb=None, bias=torch.zeros(8),
                affine_a=torch.zeros((1, 2, 4)), affine_b=None, compute_dtype=None)
    args.update(change)
    return args


def _stack_args(**change):
    args = dict(x=torch.zeros((1, 5, 128)), A=torch.zeros((2, 128, 768)),
                w2=torch.zeros((2, 256, 128)), vecs=torch.zeros((2, 16, 256)),
                n_heads=4)
    args.update(change)
    return args


@pytest.mark.parametrize("check,args,error", [
    (cu._check_cuda_inputs, _conv_args(), None),
    (cu._check_cuda_inputs, _conv_args(xa=torch.zeros((1, 4, 6, 6, 6)).half()), TypeError),
    (cu._check_cuda_inputs, _conv_args(xa=torch.zeros((1, 4, 6, 6, 6)).transpose(2, 3)),
     ValueError),
    (cu._check_cuda_inputs, _conv_args(wa=torch.zeros((8, 4, 3, 3, 3)).double()), TypeError),
    (cu._check_cuda_inputs, _conv_args(compute_dtype=torch.float16), ValueError),
    (cu._check_cuda_inputs, _conv_args(xb=torch.zeros((1, 2, 6, 6, 6))), ValueError),
    (cu._check_cuda_inputs, _conv_args(affine_a=torch.zeros((1, 2, 3))), ValueError),
    (cu._check_cuda_inputs, _conv_args(bias=torch.zeros(8, requires_grad=True)),
     NotImplementedError),
    (fs._check_cuda_inputs, _stack_args(), None),
    (fs._check_cuda_inputs, _stack_args(x=torch.zeros((1, 5, 128)).half()), TypeError),
    (fs._check_cuda_inputs, _stack_args(x=torch.zeros((1, 10, 128))[:, ::2]), ValueError),
    (fs._check_cuda_inputs, _stack_args(n_heads=2), ValueError),
    (fs._check_cuda_inputs, _stack_args(w2=torch.zeros((1, 256, 128))), ValueError),
    (fs._check_cuda_inputs, _stack_args(x=torch.zeros((1, 5, 128), requires_grad=True)),
     NotImplementedError),
])
def test_cuda_input_checks(check, args, error):
    """The wrappers' checks before a launch, run on CPU tensors: what the
    kernels take passes, the rest raises."""
    if error is None:
        check(*args.values())
    else:
        with pytest.raises(error):
            check(*args.values())


def _probe_calls():
    rng = np.random.default_rng(2)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, w = rnd(2, 40, 32).bfloat16(), rnd(9, 32, 16).bfloat16()
    z = rnd(1, 3, 4, inner_probe.WC, 128).bfloat16()
    kp, ku, kd = rnd(3, 3, 128, 128), rnd(3, 3, 64, 64), rnd(3, 3, 64, 64)
    xc, kc = rnd(4, 4, 16, 16), rnd(3, 3, 3, 16, 32)
    return [
        (dot_probe.tap_sum, lambda: dot_probe.tap_sum(x, w)),
        (rowoffset_probe.row_offset_sum,
         lambda: rowoffset_probe.row_offset_sum(x, w, [0, 3, 7] * 3, m=30)),
        (inner_probe.inner_step_packed, lambda: inner_probe.inner_step(z, kp, ku, kd, 2)),
        (conv_prototype.conv3d_cl, lambda: conv_prototype.conv3d_cl(xc, kc)),
        (conv_retired.conv3d_cl_rows,
         lambda: conv_retired.conv3d_cl_rows(xc[None], kc, rnd(32))),
        (in_stats_probe.lane_sums, lambda: in_stats_probe.lane_sums(x.reshape(2, 8, 5, 32))),
    ]


@pytest.mark.parametrize("index", range(6))
def test_probe_wrappers_take_plain_path_on_cpu_without_counting(index):
    counted, call = _probe_calls()[index]
    before = counted.launches
    out = call()
    assert counted.launches == before
    assert torch.isfinite(out.float()).all()
