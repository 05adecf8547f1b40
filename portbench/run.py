"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in ``BENCHMARK.json``, its configuration in
``portbench/configs/`` and its traffic mix in ``portbench/traffic/``, and
hands them to the loop of the mix's kind (``portbench/loops/``). With
``--trace 0`` the last line of standard output holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones; both hold ``correct``, which
the plain reference decides (``portbench/check.py``). Without a visible
CUDA device, or with fewer than the cell asks for, it exits with 2 and
prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    caches()
    import torch

    from portbench import generate, harness

    bench = harness.manifest()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}; the benchmark has {sorted(cells)}",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{found} visible. It measures the card and never falls back to the CPU.",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    config = generate.load_json("configs", cell["config"])
    traffic = generate.load_json("traffic", cell["traffic"])
    loop = importlib.import_module(f"portbench.loops.{traffic['kind']}")
    return loop.run(args, bench, cell, config, traffic, T0)


if __name__ == "__main__":
    sys.exit(main())
