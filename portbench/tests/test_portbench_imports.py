"""Nothing the benchmark runs loads JAX or the JAX package: each cell's
set-up is rehearsed on the CPU in a fresh process, and then every loaded
module's top-level name (the part before the first dot) is compared whole
with the forbidden ones, since the port's name begins with the JAX
package's. No reference module (``portbench/reference/*.py``, a configuration's own
included) loads anything of the port either."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

ROOT = os.path.dirname(harness.ROOT)
REHEARSE = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness, program
from portbench.tests import small
from portbench.loops import worklist, train
bench = harness.manifest()
cell = {{c["name"]: c for c in bench["workloads"]}}[{cell!r}]
config = small.config(cell["config"])
import torch
state = program.weights(config, 3, torch.device("cpu"))
model = program.build_model(config, state, torch.device("cpu"))
if "serve" in cell["name"]:
    program.eval_runner(model, small.worklist())
else:
    program.train_step(model.train(), small.train())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REFERENCE = """
import glob, importlib, json, os, sys
sys.path.insert(0, {root!r})
for path in sorted(glob.glob(os.path.join({root!r}, "portbench", "reference", "*.py"))):
    importlib.import_module("portbench.reference." + os.path.basename(path)[:-3])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str):
    env = dict(os.environ, USE_FLAX="0")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", [c["name"] for c in harness.manifest()["workloads"]])
def test_no_jax_in_a_cells_setup(cell):
    names = _top_level(REHEARSE.format(root=ROOT, cell=cell))
    assert "lintransunet_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "lintransunet_tpu"}


def test_reference_loads_neither_package():
    names = _top_level(REFERENCE.format(root=ROOT))
    assert not names & {"jax", "jaxlib", "flax", "lintransunet_tpu", "lintransunet_tpu_torch"}


def test_the_check_compares_whole_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lintransunet_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_the_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "flagship-serve",
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_run_fails_with_only_the_benchmarks_files(tmp_path):
    import shutil

    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "flagship-serve",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
