"""What every loop shares: the manifest, the cell's files, the per-layer
readers, and the run's last line."""

import importlib.util
import json
import math
import os
import sys
from typing import Dict, Optional

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MANIFEST = os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "lintransunet_tpu")


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, section: str):
    """The ``section`` ("end_to_end" or "per_layer") metrics this cell
    reports: those that list it, and those without a list that move an
    end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def read_layers(bench: dict, cell: str, ctx: dict) -> Dict[str, float]:
    """{name: value} of every per-layer metric of the cell whose reader
    (``metrics/<name>.py``, ``read(ctx)``) found something to read."""
    out = {}
    for metric in cell_metrics(bench, cell, "per_layer"):
        path = os.path.join(ROOT, "metrics", f"{metric['name']}.py")
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(out)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(ctx)
        if value is not None and math.isfinite(value):
            out[metric["name"]] = float(value)
    return out


def worst(bench: dict, per_rank: list) -> Dict[str, float]:
    """Each per-layer metric over ranks at its worst: the highest of a
    lower-is-better one, the lowest of the others; a sum where the metric is
    a rate over the whole mesh (``mfu``) is already taken by its reader."""
    better = {m["name"]: m["better"] for m in bench["per_layer"]}
    out = {}
    for name in per_rank[0]:
        values = [r[name] for r in per_rank if name in r]
        out[name] = max(values) if better[name] == "lower" else min(values)
    return out


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def device(dev, count: int, peak_bytes: int, traced: Optional[dict] = None) -> dict:
    """The result's ``device``; a CPU rehearsal says so ("cpu")."""
    gpu = dev.type == "cuda"
    out = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(dev) if gpu else "cpu", "count": count,
           "memory_peak_bytes": int(peak_bytes)}
    if traced:
        out.update(traced)
    return out


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def emit(bench: dict, cell: str, trace: bool, values: Dict[str, float], correct: bool,
         checks: dict, attempted: int, failed: int, dev: dict,
         breakdown: Optional[dict] = None) -> int:
    """Print the compared numbers on stderr and the result as the last line
    of stdout; 3 (and no result) if a module of JAX or of the JAX package is
    loaded."""
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: modules of JAX or of the JAX package are loaded: {loaded}",
              file=sys.stderr, flush=True)
        return 3
    section = "per_layer" if trace else "end_to_end"
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in cell_metrics(bench, cell, section) if m["name"] in values}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace and breakdown:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
