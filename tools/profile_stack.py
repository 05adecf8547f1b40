"""Where the transformer-stack kernel's time goes on one CUDA card.

    python3 tools/profile_stack.py [--phases]

At the four token stacks of a window of the fused configuration
(``chip_smoke.STACK_SHAPES``), bf16, with ``chip_smoke``'s random weights:

* ``[call]``: CUDA-event ms per call of ``fused_transformer_stack`` at one
  and seven layers, and its executed TFLOP/s;
* ``[kernel]``: ``torch.profiler`` device time per call of each kernel the
  call launches, at seven layers;
* ``--phases``: the library built again with ``-DFST_PHASES``, which adds
  clock64 marks to the kernel that applies a layer; prints each phase's
  share of a block's cycles and the cycles per block.

Builds go to ``lintransunet_tpu_torch/_build/`` (git-ignored), each keyed
on its flags; the plain build is the one the wrappers use.
"""

import argparse
import ctypes
import subprocess
import sys
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from lintransunet_tpu_torch.experiments.common import cuda_ms  # noqa: E402
from lintransunet_tpu_torch.kernels import build  # noqa: E402
from lintransunet_tpu_torch.ops import fused_stack as fs  # noqa: E402

# the layer kernel's phases (`Phase` in csrc/fused_stack.cu); `weights` is
# the wait for a weight chunk and its barrier
PHASES = ("load", "weights", "mma", "softmax_ctx", "ln1", "gelu", "ln2")
PHASE_SHAPES = [(4096, 256), (5376, 256), (28704, 128)]
ITERS = 10


def inputs(n, c, layers, seed=chip_smoke.SEED + 3):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    A = (rnd(layers, c, 6 * c) / c ** 0.5).to("cuda")
    w2 = (rnd(layers, 2 * c, c) / (2 * c) ** 0.5).to("cuda")
    vecs = rnd(layers, 16, 2 * c) * 0.1
    vecs[:, 6] += 1.0
    vecs[:, 8] += 1.0
    x = rnd(1, n, c).to("cuda", torch.bfloat16)
    return x, A, w2, vecs.to("cuda"), c // fs.D_K


def flops(n, c, layers):
    return layers * n * (16 * c * c + 4 * c * fs.D_K)


def time_calls():
    for n, c in chip_smoke.STACK_SHAPES:
        for layers in (1, 7):
            args = inputs(n, c, layers)
            ms = cuda_ms(lambda: fs.fused_transformer_stack(*args), ITERS, 2)
            print(f"[call] N={n} C={c} L={layers}: {ms:.4f} ms, "
                  f"{flops(n, c, layers) / ms * 1e-9:.1f} TFLOP/s", flush=True)


def per_kernel():
    for n, c in chip_smoke.STACK_SHAPES:
        args = inputs(n, c, 7)
        fs.fused_transformer_stack(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fs.fused_transformer_stack(*args)
            torch.cuda.synchronize()
        per = defaultdict(lambda: [0.0, 0])
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per[e.name][0] += e.time_range.elapsed_us() / 3
                per[e.name][1] += 1
        for name, (us, count) in sorted(per.items(), key=lambda kv: -kv[1][0]):
            print(f"[kernel] N={n} C={c} L=7: {us / 1e3:.4f} ms per call over "
                  f"{count // 3} launches of {name[:100]}", flush=True)


def phases():
    lib = build.load("fused_stack", ("-DFST_PHASES",))
    lib.fst_phase_clocks.restype = ctypes.c_int
    lib.fst_phase_clocks.argtypes = [ctypes.c_void_p]
    build._loaded["fused_stack"] = lib  # the wrapper launches this build
    sums = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    for n, c in PHASE_SHAPES:
        args = inputs(n, c, 7)
        fs.fused_transformer_stack(*args)
        if lib.fst_phase_clocks(ctypes.addressof(sums)) != 0:
            chip_smoke.fail("fst_phase_clocks failed")
        for _ in range(3):
            fs.fused_transformer_stack(*args)
        if lib.fst_phase_clocks(ctypes.addressof(sums)) != 0:
            chip_smoke.fail("fst_phase_clocks failed")
        cycles = list(sums[:len(PHASES)])
        blocks = sums[len(PHASES)]
        total = sum(cycles)
        shares = ", ".join(f"{name} {cyc / total * 100:.1f}%"
                           for name, cyc in zip(PHASES, cycles) if cyc)
        print(f"[phases] N={n} C={c}: {total / blocks:.0f} cycles per block and "
              f"layer ({blocks} blocks over 3 calls of 7 layers): {shares}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", action="store_true",
                        help="clock64 phase split of the layer kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs only on an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    builds = [()] + ([("-DFST_PHASES",)] if args.phases else [])
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per build, all at once
        list(pool.map(lambda flags: build.build_libraries("fused_stack", flags=flags), builds))
    time_calls()
    per_kernel()
    if args.phases:
        phases()


if __name__ == "__main__":
    main()
