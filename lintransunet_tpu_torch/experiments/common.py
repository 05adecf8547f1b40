"""What the probes' ``main()``s share: the card's peaks, CUDA-event timing
(back to back from the host, or the card's own time behind a sleep, and the
host's time a call), the bound, and the command line."""

import argparse
import subprocess
import time

import torch

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SMEM_LIMIT = 232448                             # bytes a block can use


def bound(flops, nbytes, dtype=torch.bfloat16):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    the larger of the bytes at HBM rate and the operations at peak."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, iters=20, warmup=3):
    """Mean ms of ``fn`` over ``iters`` back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns, iters=20, warmup=2):
    """Mean ms of each of ``fns`` timed alike: each warmed by ``warmup``
    calls, then ``iters``-call windows in the order given and again in
    reverse (for a kernel and its library call: kernel, library, library,
    kernel), each window's mean averaged over its two turns."""
    for fn in fns:
        cuda_ms(fn, warmup, warmup=0)
    order = list(range(len(fns)))
    times = [0.0] * len(fns)
    for i in order + order[::-1]:
        times[i] += cuda_ms(fns[i], iters, warmup=0) / 2
    return times


SLEEP_CYCLES = 200_000_000  # ~0.1 s of the card: longer than a window of calls takes to issue


def _behind_sleep(fn, iters):
    """Runs ``fn`` once, then queues ``iters`` calls behind a
    ``torch.cuda._sleep``: (events after the sleep, the host's seconds to
    issue the calls). The calls then run back to back on the card whatever
    the host's speed."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issued = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start, end, issued


def card_ms(fn, iters=50):
    """The card's ms per call, gaps between launches included: ``iters``
    calls queued behind a sleep, timed by events."""
    start, end, _ = _behind_sleep(fn, iters)
    return start.elapsed_time(end) / iters


def host_us(fn, iters=50):
    """The host's µs per call, the card kept busy so that no call waits:
    what a call costs the launching thread."""
    return _behind_sleep(fn, iters)[2] / iters * 1e6


def kernel_us(fn, iters=10):
    """{kernel name: device µs per call} from ``torch.profiler``'s device rows."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            times[name.split("(")[0][:40]] = e.device_time_total / iters
    return times


def card_line(kernel, library=None, kernels=False, label="library"):
    """One printed line of card and host times: the kernel's call and the
    library call (where given, named ``label``) each by ``card_ms`` and
    ``host_us``; with ``kernels``, the kernel call's device time by kernel
    (``kernel_us``)."""
    card = f"  card: kernel {card_ms(kernel):.4f} ms"
    host = f"host: kernel {host_us(kernel):.1f} us"
    if library is not None:
        card += f", {label} {card_ms(library):.4f} ms"
        host += f", {label} {host_us(library):.1f} us"
    line = f"{card}; {host}"
    if kernels:
        line += "; device: " + ", ".join(f"{k} {v:.2f} us" for k, v in kernel_us(kernel).items())
    return line


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def parse_device(description):
    """``--device`` from the command line: 'cuda' (the default) needs a
    card; 'cpu' runs the plain versions at a reduced size."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = parser.parse_args().device
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: run on an NVIDIA GPU, or pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"card: {card()}; torch {torch.__version__}", flush=True)
    else:
        print("device cpu: the plain PyTorch versions at a reduced size; no kernel, "
              "and no time here is a card's", flush=True)
    return torch.device(device)


def rate_line(name, ms, flops, nbytes, library_ms=None, dtype=torch.bfloat16,
              executed_flops=None):
    """One printed line: ms, rate, share of the bound and the library time.
    ``flops`` are those the function needs (they set the bound);
    ``executed_flops``, where given, those the kernel runs, printed as the
    tensor cores' rate."""
    bound_ms, by = bound(flops, nbytes, dtype)
    rate = (f"{flops / ms / 1e9:8.1f} TFLOP/s" if by == "operations"
            else f"{nbytes / ms / 1e6:8.1f} GB/s")
    lib = "" if library_ms is None else f"  library {library_ms:8.4f} ms"
    run = ("" if executed_flops is None
           else f"  products run at {executed_flops / ms / 1e9:6.1f} TFLOP/s")
    return (f"{name:<48s} {ms:8.4f} ms {rate}  bound {bound_ms:8.4f} ms ({by}), "
            f"{bound_ms / ms * 100:5.1f}% of it{lib}{run}")
