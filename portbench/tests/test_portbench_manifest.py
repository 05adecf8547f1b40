import json
import os
import re

import pytest

from portbench import generate, harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOT = os.path.dirname(harness.ROOT)
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", [m["name"] for m in METRICS]
                         + [c["name"] for c in BENCH["workloads"] + BENCH["configs"]])
def test_names(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_units_and_keys(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("device_trace", "host_clock")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert os.path.exists(os.path.join(harness.ROOT, "metrics", metric["name"] + ".py"))


def test_every_cell_has_its_files_setup_and_a_layer_metric():
    names = {c["name"] for c in BENCH["configs"]}
    for cell in BENCH["workloads"]:
        assert cell["config"] in names and cell["chips"] in (1, 4)
        generate.load_json("traffic", cell["traffic"])
        assert os.path.exists(os.path.join(harness.ROOT, "limits", cell["name"] + ".json"))
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(BENCH, cell["name"], "per_layer")
        assert len(cell["why"]) <= 200
    pairs = [(c["config"], c["traffic"]) for c in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = os.path.join(ROOT, config["file"])
    assert path.startswith(harness.ROOT)
    with open(path) as f:
        data = json.load(f)
    for key in ("source", "reduced", "assumed", "flops", "attention_calls", "model",
                "model_kwargs", "compute_dtype"):
        assert key in data
    assert data["reduced"] == config["reduced"] and data["source"] == config["source"]


def test_manifest_is_small():
    assert os.path.getsize(harness.MANIFEST) < 64 * 1024
