"""Where the flagship's training step spends its time on one CUDA card.

    python3 tools/profile_train.py

Builds the training step as ``chip_smoke.py`` phase 7 does (the flagship,
bf16 compute, f32 parameters, dropout 0.3, one 512 x 512 x 32 patch, the
5-level criterion schedule with the epoch-0 weights, AdamW at lr 1e-4)
and prints, all warm:

* ``step``: STEP_RUNS steps, host clock around each synchronised step, and
  the mean of the same steps run back to back with one synchronise;
* ``profile``: ``torch.profiler`` over PROFILED_STEPS steps, device rows
  only (kernels, memcpy, memset; not the GPU user annotations such as the
  optimizer's step range): the summed device time and launches per step,
  the busy time (the union of the rows' intervals, which is less than the
  sum where rows overlap), the idle share 1 - busy time / unprofiled step
  wall time, device time by class and the top kernels.
"""

import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
import profile_window  # noqa: E402
from lintransunet_tpu_torch import engine  # noqa: E402

STEP_RUNS = 10
PROFILED_STEPS = 3
TOP = 25
# kernel-name substrings -> class, ahead of the serving classes; the first
# match wins
CLASSES = [
    ("linear-attention backward kernel", ("lta_fold<__nv_bfloat16, true>", "lta_fold<float, true>",
                                          "lta_bwd_tokens", "bwd_partial", "bwd_combine",
                                          "bwd_tokens")),
    ("AdamW (foreach)", ("multi_tensor_apply", "foreach")),
    ("conv3d backward", ("dgrad", "wgrad", "convolve_sgemm_backward", "conv_depthwise3d_backward")),
    ("trilinear upsample backward", ("upsample_trilinear3d_backward",)),
] + profile_window.CLASSES


def classify(name):
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def busy_us(events):
    """Length of the union of the events' device intervals, in us."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def main():
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs only on an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    images, labels, criterions = chip_smoke.train_inputs()
    model = chip_smoke.build_model().train()
    state = engine.create_train_state(model, learning_rate=1e-4)
    step = engine.make_train_step(model, criterions)
    gen = chip_smoke.dropout_generator()

    def run():
        step(state, images, labels, chip_smoke.DYNAMIC_WEIGHT, gen)

    for _ in range(2):
        run()
    step_s = [profile_window.synced(run) for _ in range(STEP_RUNS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEP_RUNS):
        run()
    torch.cuda.synchronize()
    streamed_ms = (time.perf_counter() - t0) / STEP_RUNS * 1e3
    print(f"[step] synchronised: {profile_window.spread(step_s)}", flush=True)
    print(f"[step] back to back, one synchronise: {streamed_ms:.2f} ms per step "
          f"(n={STEP_RUNS})", flush=True)

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            run()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        chip_smoke.fail("the profiler recorded no device rows")
    per_class, per_kernel = defaultdict(float), defaultdict(lambda: [0.0, 0])
    for e in device:
        us = e.time_range.elapsed_us() / PROFILED_STEPS
        per_class[classify(e.name)] += us
        per_kernel[e.name][0] += us
        per_kernel[e.name][1] += 1
    total_ms = sum(per_class.values()) / 1e3
    busy_ms = busy_us(device) / PROFILED_STEPS / 1e3
    wall_ms = statistics.mean(step_s) * 1e3
    streams = len({e.device_resource_id for e in device})
    print(f"[profile] device time {total_ms:.2f} ms per step summed over "
          f"{len(device) / PROFILED_STEPS:.0f} launches per step on {streams} "
          f"stream(s); busy {busy_ms:.2f} ms per step; idle "
          f"{(1 - busy_ms / wall_ms) * 100:.1f}% of the {wall_ms:.2f} ms "
          f"unprofiled synchronised step, "
          f"{(1 - busy_ms / streamed_ms) * 100:.1f}% of the {streamed_ms:.2f} ms "
          f"back-to-back step", flush=True)
    for cls, us in sorted(per_class.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {cls:34s} {us / 1e3:8.3f} ms "
              f"{us / 1e3 / total_ms * 100:5.1f}%", flush=True)
    for name, (us, n) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"[kernel] {us / 1e3:8.3f} ms {n / PROFILED_STEPS:6.0f} x "
              f"{name[:110]}", flush=True)


if __name__ == "__main__":
    main()
