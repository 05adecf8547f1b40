"""The port's utils (``lintransunet_tpu_torch.utils``) against the JAX
package's, as ``tests/test_utils.py:39,50`` holds those: the NaN guards on
the same values, and the synchronised timer; and a profiler trace on disk."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.utils import finite_check as jax_finite_check
from lintransunet_tpu_torch.utils import finite_check, nan_guard, profile_trace, timed
from lintransunet_tpu_torch.utils.debug import enable_nan_debugging


def test_finite_check_and_nan_guard(capsys):
    trees = {"good": {"a": np.ones(3, np.float32), "b": np.zeros((2, 2), np.float32)},
             "bad": {"a": np.asarray([1.0, float("nan")], np.float32)},
             "inf in a list": {"a": [np.ones(2, np.float32), np.asarray([np.inf], np.float32)]},
             "integers only": {"a": np.arange(3)}}
    for name, tree in trees.items():
        want = jax_finite_check({k: [jnp.asarray(x) for x in v] if isinstance(v, list)
                                 else jnp.asarray(v) for k, v in tree.items()})
        got = finite_check({k: [torch.from_numpy(x) for x in v] if isinstance(v, list)
                            else torch.from_numpy(v) for k, v in tree.items()})
        assert got == want, name
    model = torch.nn.Linear(2, 2)
    assert finite_check(model)
    with torch.no_grad():
        model.bias[0] = float("inf")
    assert not finite_check(model)

    x = torch.ones(4)
    assert nan_guard(x, "x") is x
    assert capsys.readouterr().out == ""
    y = nan_guard(torch.tensor([1.0, float("nan")], dtype=torch.bfloat16), "y")
    assert torch.isnan(y[1])
    assert capsys.readouterr().out == "[nan_guard] non-finite values in y\n"


def test_enable_nan_debugging():
    before = torch.is_anomaly_enabled()
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0 - 1.0).sum().backward()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_timed_forces_sync():
    secs, result = timed(lambda v: v * 2, torch.ones((8, 8)), warmup=1, iters=2)
    assert secs > 0
    np.testing.assert_allclose(result.numpy(), 2.0)
    calls = []
    secs, result = timed(lambda: calls.append(1) or {"out": [torch.zeros(2)]},
                         warmup=2, iters=3)
    assert len(calls) == 5 and secs >= 0 and torch.equal(result["out"][0], torch.zeros(2))


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(str(tmp_path), device="cpu"):
        torch.ones((64, 64)) @ torch.ones((64, 64))
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(traces) == 1
    assert "aten::mm" in (tmp_path / traces[0]).read_text()


def test_profile_trace_runs_on_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default traces it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile_trace(str(tmp_path)):
            pass
