"""Where the flagship's serving time goes on one CUDA card.

    python3 tools/profile_window.py [--fused]

Builds the flagship as ``chip_smoke.py`` does (bf16 compute, random weights
from its seed; with ``--fused`` in the fused eval configuration,
``fused_s1=True, fused_stack=True``) behind ``make_eval_runner`` and
prints, all warm:

* ``window``: one 512 x 512 x 64 window forward, host clock around a
  synchronised call, mean of WINDOW_RUNS;
* ``volume``: ``runner(volume)`` on a 512 x 512 x 144 volume (5 windows),
  each of VOLUME_RUNS;
* ``blend``: the same runner call with the model replaced by a predictor
  that returns a stored window output: padding, the window grid, the canvas
  blend, the crop and the derived background, without the forwards;
* ``profile``: ``torch.profiler`` over PROFILED_WINDOWS window forwards,
  counting device rows only (kernels, memcpy, memset): device time and
  launches per window, the idle share 1 - device time / unprofiled window
  wall time, device time by class and the top kernels.

The printed names and numbers are the same in every tree that has
``make_eval_runner``, so two trees can be compared in one call.
"""

import argparse
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from lintransunet_tpu_torch.cli.common import EvalConfig, make_eval_runner  # noqa: E402
from lintransunet_tpu_torch.engine import SlidingWindowRunner  # noqa: E402

WINDOW_RUNS = 10
VOLUME_RUNS = 10
PROFILED_WINDOWS = 3
TOP = 20
# kernel-name substrings -> class; the first match wins
CLASSES = [
    ("transformer-stack kernel", ("stack_kv_partial", "stack_ctx_combine",
                                  "stack_apply_layer")),
    ("conv-unit kernel", ("conv_unit_", "stats_reduce")),
    ("linear-attention kernel", ("ctx_partial", "ctx_combine", "attn_out")),
    ("cuDNN layout transposes", ("nhwcToNchw", "nchwToNhwc")),
    ("conv3d", ("fprop", "conv", "cudnn")),
    ("trilinear upsample", ("upsample",)),
    ("layer_norm", ("layer_norm",)),
    ("reductions", ("reduce_kernel",)),
    ("GEMMs", ("gemm", "cutlass", "nvjet")),
    ("elementwise and copies", ("elementwise", "copy", "Memcpy", "Memset")),
]


def synced(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def spread(xs):
    return (f"mean {statistics.mean(xs) * 1e3:.2f} ms, median "
            f"{statistics.median(xs) * 1e3:.2f}, min {min(xs) * 1e3:.2f}, "
            f"max {max(xs) * 1e3:.2f} (n={len(xs)})")


def classify(name):
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--fused", action="store_true",
                        help="profile the fused eval configuration")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs only on an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(f"[config] {'fused' if args.fused else 'default'}", flush=True)
    model = (chip_smoke.build_model("kernel", fused_config=True) if args.fused
             else chip_smoke.build_model("kernel"))
    roi = EvalConfig(roi_size=512, depth_size=64, overlap=0.6, mode="constant")
    fwd, runner = make_eval_runner(model, roi)
    gen = torch.Generator(device="cpu").manual_seed(chip_smoke.SEED + 1)
    volume = torch.randn(chip_smoke.VOLUME, generator=gen).to("cuda")
    window = volume[..., :64].contiguous()

    for _ in range(2):
        runner(volume)
    window_s = [synced(lambda: fwd(window)) for _ in range(WINDOW_RUNS)]
    volume_s = [synced(lambda: runner(volume)) for _ in range(VOLUME_RUNS)]
    stored = fwd(window)
    blender = SlidingWindowRunner(lambda x: stored, runner.roi_size,
                                  overlap=runner.overlap, mode=runner.mode,
                                  derive_background=runner.derive_background)
    blender(volume)
    blend_s = [synced(lambda: blender(volume)) for _ in range(VOLUME_RUNS)]
    print(f"[window] {spread(window_s)}", flush=True)
    print(f"[volume] {spread(volume_s)}; 5 windows take "
          f"{5 * statistics.mean(window_s) * 1e3:.2f} ms of it", flush=True)
    print(f"[blend] {spread(blend_s)}", flush=True)

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_WINDOWS):
            fwd(window)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        chip_smoke.fail("the profiler recorded no device rows")
    per_class, per_kernel = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in device:
        us = e.time_range.elapsed_us() / PROFILED_WINDOWS
        per_class[classify(e.name)] += us
        per_kernel[e.name][0] += us
        per_kernel[e.name][1] += 1
    total_ms = sum(per_class.values()) / 1e3
    wall_ms = statistics.mean(window_s) * 1e3
    print(f"[profile] device time {total_ms:.2f} ms per window, "
          f"{len(device) / PROFILED_WINDOWS:.0f} launches per window, idle "
          f"{(1 - total_ms / wall_ms) * 100:.1f}% of the {wall_ms:.2f} ms "
          f"unprofiled window", flush=True)
    for cls, us in sorted(per_class.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {cls:26s} {us / 1e3:8.3f} ms "
              f"{us / 1e3 / total_ms * 100:5.1f}%", flush=True)
    for name, (us, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"[kernel] {us / 1e3:8.3f} ms {n / PROFILED_WINDOWS:6.0f} x "
              f"{name[:110]}", flush=True)


if __name__ == "__main__":
    main()
