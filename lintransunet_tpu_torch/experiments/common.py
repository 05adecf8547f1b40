"""What the probes' ``main()``s share: the card's peaks, CUDA-event timing,
the bound, and the command line."""

import argparse
import subprocess

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
