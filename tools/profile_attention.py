"""Where the linear-attention kernels' time goes on one CUDA card.

    python3 tools/profile_attention.py [--layout contiguous|heads]

At the window's four serving shapes (``chip_smoke.MAIN_SHAPES``, forward)
and the training patch's four (``chip_smoke.TRAIN_SHAPES``, backward), bf16,
random inputs from ``chip_smoke``'s seed, in the layout given:
``contiguous`` (B, H, N, d), or ``heads``, the head-split view
``t.view(B, N, H, d).transpose(1, 2)`` of a (B, N, H·d) projection, which
is what the model passes. For each call it prints:

* ``ms``: CUDA-event mean per call over ITERS calls back to back (where the
  host is slower than the card, this is the host's rate);
* ``busy``: the same calls queued behind a ~50 ms ``torch.cuda._sleep`` so
  that they run back to back on the card whatever the host's speed: the
  card's time per call, gaps between launches included;
* ``host``: the host's time per call over HOST_CALLS calls with no
  synchronise in between (what a call costs the launching thread);
* ``launches``: the host's ``cudaLaunch*`` calls per call under
  ``torch.profiler``, and each kernel's device time per call from the
  device rows the profiler kept (on the H100 now and then fewer than the
  kernels that ran).

Then the window's 32 forward calls and the step's 32 backward calls summed
(8 calls at each shape). Only the wrappers' public names are used, so a copy
of this file runs in an older tree of the port too (``contiguous``).
"""

import argparse
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from lintransunet_tpu_torch.experiments.common import cuda_ms  # noqa: E402
from lintransunet_tpu_torch.ops import linear_attention as fused  # noqa: E402

ITERS = 50
HOST_CALLS = 200
PROFILED_CALLS = 20
BUSY_CALLS = 200
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock: longer than queueing the calls
HEADS = 8  # the model's heads; BH 4 at N 28704 is one batch of 4 heads


def make(bh, n, d, layout, gen):
    """One bf16 (B, H, N, d) tensor on the card in ``layout``."""
    h = HEADS if bh % HEADS == 0 else bh
    b = bh // h
    x = torch.randn((b, n, h * d), generator=gen).to("cuda", torch.bfloat16)
    view = x.view(b, n, h, d).transpose(1, 2)
    return view if layout == "heads" else view.contiguous()


def profile_call(fn):
    """(launches per call, {kernel name: device us per call})."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(e.device_type == DeviceType.CPU and e.name.startswith("cudaLaunch")
                   for e in events)
    per = defaultdict(float)
    for e in events:
        if e.device_type == DeviceType.CUDA:
            per[e.name] += e.time_range.elapsed_us() / PROFILED_CALLS
    return launches / PROFILED_CALLS, per


def busy_us(fn):
    """Card time per call with the calls queued ahead (see the docstring)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(BUSY_CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / BUSY_CALLS * 1e3


def host_us(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / HOST_CALLS * 1e6


def measure(label, shapes, layout, make_call):
    gen = torch.Generator(device="cpu").manual_seed(chip_smoke.SEED)
    total_ms, total_dev, total_busy = 0.0, 0.0, 0.0
    for bh, n, d in shapes:
        fn = make_call(bh, n, d, layout, gen)
        ms = cuda_ms(fn, ITERS, warmup=5)
        busy = busy_us(fn)
        host = host_us(fn)
        launches, per = profile_call(fn)
        dev = sum(per.values())
        total_ms += 8 * ms
        total_dev += 8 * dev
        total_busy += 8 * busy
        kernels = ", ".join(f"{name[:40]} {us:.2f}"
                            for name, us in sorted(per.items(), key=lambda kv: -kv[1]))
        print(f"[{label}] {layout} BH={bh} N={n} d={d}: {ms * 1e3:.2f} us per call "
              f"(events), busy {busy:.2f} us, host {host:.2f} us, {launches:g} launches, "
              f"device {dev:.2f} us: {kernels}", flush=True)
    return total_ms, total_dev, total_busy


def forward_call(bh, n, d, layout, gen):
    q, k, v = (make(bh, n, d, layout, gen) for _ in range(3))
    return lambda: fused.linear_attention(q, k, v)


def backward_call(bh, n, d, layout, gen):
    q, k, v, g = (make(bh, n, d, layout, gen) for _ in range(4))
    return lambda: fused.linear_attention_backward(q, k, v, g)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--layout", choices=("contiguous", "heads"), default="contiguous")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs only on an NVIDIA GPU")
    print(f"[config] layout {args.layout}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    fwd = measure("forward", chip_smoke.MAIN_SHAPES, args.layout, forward_call)
    bwd = measure("backward", chip_smoke.TRAIN_SHAPES, args.layout, backward_call)
    print(f"[sum] {args.layout}: the window's 32 forward calls {fwd[0]:.4f} ms (events), "
          f"busy {fwd[2] / 1e3:.4f} ms, device {fwd[1] / 1e3:.4f} ms; the step's 32 "
          f"backward calls {bwd[0]:.4f} ms (events), busy {bwd[2] / 1e3:.4f} ms, device "
          f"{bwd[1] / 1e3:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
