"""Drive the PyTorch port's serving, training and CLI paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its findings; any failure exits non-zero before the
last line):

1. card: ``nvidia-smi`` name and power limit, the device name, and the
   nvcc builds of the CUDA kernels from ``lintransunet_tpu_torch/csrc``
   (one nvcc per source, all started together) with their ptxas reports
   per kernel (the probes' tensor-core kernels, ``conv_mma`` and each
   instance of ``taps_fold``, ``taps_fold_weights`` and ``inner_taps``, with
   their registers and spills on a line of their own), and the bf16 stack
   kernels' grid, shared memory and blocks per SM;
2. each kernel's wrapper against its plain version on the card, in this
   process: the card tests chosen by KERNEL_TEST_NAMES
   (``tests/test_torch_cuda.py``: the attention calls of the window and the
   training patch at the serve and train batches, in the model's layouts,
   and at the other models' head widths; the fused build's conv units and
   token stacks; the routed convolutions at both batches; each probe's
   entry point at its main shape) and the bf16 flagship's graphed
   micro-steps against the eager one (``tests/test_torch_cuda_graphs.py``);
   the tests own every shape and tolerance, and a failure fails the script;
3. the default path at full width: the flagship ``MaskTransUnet`` (random
   weights from a seed, f32 parameters, bf16 compute) behind
   ``make_eval_runner`` answers three 512 x 512 x 144 volumes (5 windows
   each); the attention kernel must launch 32 times a window, conv_narrow 5
   times (``NARROW_CALLS``), conv_depthwise 4 times (``PEG_CALLS``) and the
   other kernels never;
4. kernel vs plain attention end to end on one window of the default path:
   in bf16 and f32 the ConnectBridge output and the coarsest mask (both
   upstream of the first ROI box threshold) within PRE_THRESHOLD_TOL; the
   f32 foreground labels agree on at least 99.9% of voxels;
4b. the model's one QKV product against the three products of the JAX
    package's default path (``three_products``, patched in for
    ``MultiheadLinearAttention.forward``) on the same weights: one window
    held as phase 4 (bf16 and f32 upstream of the first ROI box, the f32
    labels), 32 attention launches a window, the window's CUDA launches
    each way; one f32 train step within TRAIN_TOL, 32 forward and 32
    backward attention launches;
5. the fused configuration at full width: the same weights with
   ``fused_s1=True, fused_stack=True`` answer the same three volumes; per
   window exactly 7 conv-unit, 8 stack, 5 conv_narrow and 4 conv_depthwise
   launches, and no standalone attention launch;
6. fused vs default end to end on one window, same weights: the
   ConnectBridge output and the coarsest mask within FUSED_TOL in bf16 and
   f32, and both configurations' window forward times. The fused conv unit
   rounds its operands to bf16 in an f32 model too (as the JAX package's),
   so the f32 labels are printed, not held, here; phase 4 holds them;
7. the binary training step at full width: the flagship (bf16 compute, f32
   parameters, dropout 0.3) on one 512 x 512 x 32 patch, the 5-level
   deep-supervision criterion schedule with the epoch-0 weights, AdamW at
   lr 1e-4; one warm step, then TRAIN_STEPS timed steps with one
   synchronise at the end. Every step's loss and gradients are finite;
   every step is a CUDA graph replay, the first after the step's warm-up
   and capture, its two passes through Python; each pass launches exactly
   32 forward and 32 backward attention kernels, 3 depthwise weight
   gradients, 5 conv_narrow and 4 conv_depthwise forwards and none of the
   others (the replays launch theirs without
   Python: one replay under the profiler shows each of the port's kernels,
   none more often than the capture launched it); prints ms per step and
   the peak memory.

   On the card every train step is such a replay (``engine.train``): the
   kernel wrappers count their calls in the passes through Python (eager
   micro-steps, warm-ups, captures; ``engine.python_passes``), so every
   launch count of a train step below is held a pass, and the replays
   against the steps taken;
8. kernel vs plain attention on one train step, same weights, batch and
   dropout generator: in f32 (TF32 off) the loss and every parameter's
   gradient within TRAIN_TOL, beside the floor that a rounding-level change
   gives (the kernel build with its weights moved by 1e-7 relative); in bf16
   the step's differences are printed, and the ConnectBridge gradients of
   the coarsest deep-supervision term alone (upstream of the first ROI box)
   are held within UPSTREAM_GRAD_TOL;
10. the binary CLIs at full width, as a user runs them: a synthetic
    workspace of four 80 x 512 x 512 (D, H, W) HU volumes with
    pancreas-sized labels and a 2-fold split by ``cli.split_dataset``; then
    ``cli.train3d`` (the flagship in bf16, 512 x 512 x 32 patches, 3 samples
    a patient, batch 1, one epoch with its eval: the fold's 2 test volumes
    through the runner, then 2 patients x 3 steps) and
    ``cli.inference_embed_attn`` (512 x 512 x 64 windows, overlap 0.6, the
    export on) on the checkpoint it wrote. Held: every logged value finite,
    ``metrics.jsonl`` with ``train/total_loss`` and ``eval/DiceClassLoss``,
    the ``temp_model``, ``train_state`` and ``model`` artifacts, 32 forward
    and 32 backward attention launches a step plus 32 forward a window of
    the runner's grid in ``train3d`` (32 a window batch in the inference),
    the depthwise weight gradients, conv_narrow 5 times a forward (4 at 3
    classes, whose final block has 12 outputs), conv_depthwise 4 times a
    forward and no other kernel, a
    (80, 512, 512) binary export, and a finite
    ``summary_4_fold.json``. Prints ms per step through the CLI beside phase
    7's, the host's data time, s per served volume, whether the native
    preprocessing core loaded, and its HU window against the numpy
    fallback on one (512, 512, 80) volume (the same bits held, both timed);
11. the multi-class CLIs at full width: phase 10's workspace with a class-2
    blob beside each class-1 one; ``cli.train3d_multi_class`` (the flagship
    at ``dim_output`` 3, the rest as phase 10), ``cli.inference_multi_classes``
    on its checkpoint, then ``cli.train3d_monai_version`` (the cached
    pipeline, resampled to 0.5 x 0.5 x 2 mm and oriented by its defaults,
    one step a batch, one epoch with its eval). Held as phase 10, with
    ``eval/DiceClassLoss2`` logged and (80, 512, 512) uint8 exports in
    {0, 1, 2}; the MONAI run's steps and exact launches from its eval
    volumes' window grid;
12. the four other models of ``Model_Dict`` (``TraditionUnet``,
    ``BottleTransUnet``, ``SkipTransUnet``, ``MaskSkipTransUnet``) at the
    flagship's widths on one 512 x 512 x 64 window in eval, bf16, with the
    kernel: the output's shape, finite probabilities whose channels sum to
    1, attention launches equal to the model's attention layers, conv_narrow
    and conv_depthwise launches equal to its routed convolutions (the bottle
    model's one each, its final block and its positional encoding); kernel vs
    plain attention in f32 on the same window (the output, or for
    ``MaskSkipTransUnet`` the bottleneck bridge and ``mask_list[0]`` upstream
    of its first ROI box and then the labels); then one f32
    ``MaskSkipTransUnet`` training step on phase 7's patch (the backward at
    d = 16), kernel vs plain within TRAIN_TOL;
13. data parallelism over ``torch.distributed`` and the "attn" recompute
    policy. Two ranks share the one card over gloo, which reduces CUDA
    tensors (NCCL refuses two ranks on one device); each phase that spawns
    ranks forms their group itself, and a rank that fails fails the script.
    gloo's all-reduce waits on the host and is no part of a graph: a
    gloo rank's micro-step replays two graphs around it:
    a. NCCL at world size 1 (a mesh from ``torchrun``'s environment): the
       DP train step on phase 7's patch (bf16, dropout 0.3, the step
       generator) against the step without a mesh, and ``run_batch`` over
       volumes of depths 144 and 80 against the runner's call on each, bit
       for bit (under ``deterministic()`` the card reruns a step bit for
       bit);
    b. two gloo ranks, the flagship in f32 (TF32 off): the DP step with
       one 512 x 512 x 32 patch a rank against one process's step on the
       joined batch of 2 within TRAIN_TOL, at dropout 0 and at dropout 0.3
       (every rank's generator seeded as the joined step's: each mask is
       the global batch's, the rank's rows kept; a gradient whose rounding
       floor, the joined step's move when the weights move by 1e-7, passes
       TRAIN_TOL is held within FLOOR_FACTOR times it), 32 forward and 32
       backward attention launches a rank, the ranks' parameters bit-equal
       after each step; the ranks' element and channel dropout masks equal
       to their rows of the joined batch's, bit for bit;
       ``batched_predictions`` over three volumes (the group padded to 4)
       equal to the runner's call on each, on both ranks;
    c. REMAT "attn" on phase 7's bf16 step, captured with its recompute
       (which takes back the forward's dropout masks): 64 forward and 32
       backward attention launches a pass, the loss and gradients against
       the step without recompute bit for bit, and both steps' peak memory;
    d. ``train3d`` on two torchrun-style gloo ranks over phase 10's
       workspace, one epoch with its eval: held as phase 10 with each
       rank's exact launches (its patients' steps and its eval volume's
       windows), only rank 0 writing ``metrics.jsonl`` and the checkpoints,
       the ranks' parameters bit-equal at the end; ms per step beside phase
       10's;
14. the floors and a training trajectory
    (``lintransunet_tpu_torch.experiments.roofline``, ``parity_training``):
    a. the counts of the default window, the fused window and the step at
       the geometry above (FLOPs, the fused and the eager bytes, the floor),
       on the host under fake tensors; the fused window's FLOPs must equal
       the default's exactly and every count be positive;
    b. each of the three timed warm on the card with the kernels, 10 runs
       back to back with one synchronise (CUDA events): median, spread,
       achieved TFLOP/s and share of the floor (the fused window's of the
       default's floor, the same function), beside the card;
    c. the binary SMALL training trajectory of the JAX package's
       ``experiments/parity_training.py`` (64 x 64 x 16 patches, dropout 0,
       f32, TF32 off), 40 steps of AdamW at lr 3e-5 with the kernels
       against the same run on the plain path from one random state, under
       ``deterministic()``: every loss finite and the largest relative loss
       difference within TRAJECTORY_TOL.

15. the user-facing entry points, each as a user starts it:
    a. ``python3 -m lintransunet_tpu_torch.bench`` (serving), the same with
       ``LINTRANSUNET_FUSED_S1=1 LINTRANSUNET_FUSED_STACK=1``, and ``...bench
       --train``, each in a subprocess: rc 0, a finite positive value, 5
       windows a volume, each kernel's launches per window (or step) as
       phases 3, 5 and 7 hold them; each JSON line printed beside the card;
    b. ``entry.entry()``: the flagship's bf16 eval forward on the zero 96^3
       patch, a finite one-hot (1, 2, 96, 96, 96), 32 attention launches;
    c. ``entry.dryrun_multichip(2)``: two gloo ranks sharing the card, bf16,
       the JAX dry run's sequence with every check held in the ranks.

The numbering skips 9, whose probes' entry points phase 2 runs; each
kernel's time is the benchmark's (``portbench``'s per-layer metrics). The
last line is ``{"ok": true, "device": {...}}``.
Imports nothing of jax.
"""

import contextlib
import ctypes
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lintransunet_tpu_torch import data, engine, kernels, native, parallel
from lintransunet_tpu_torch import entry as entry_points
from lintransunet_tpu_torch.cli import (
    inference_embed_attn,
    inference_multi_classes,
    split_dataset,
    train3d,
    train3d_monai_version,
    train3d_multi_class,
)
from lintransunet_tpu_torch.cli import common
from lintransunet_tpu_torch.cli.common import EvalConfig, get_criterion_list, make_eval_runner
from lintransunet_tpu_torch.engine import loop, make_eval_forward
from lintransunet_tpu_torch.engine.sliding_window import dense_window_starts, padded_spatial_shape
from lintransunet_tpu_torch.experiments import (
    conv_prototype,
    conv_retired,
    dot_probe,
    in_stats_probe,
    inner_probe,
    parity_training,
    roofline,
    rowoffset_probe,
)
from lintransunet_tpu_torch.experiments.common import card
from lintransunet_tpu_torch.kernels.launches import cuda_launches
from lintransunet_tpu_torch.losses import binary as binary_losses
from lintransunet_tpu_torch.models import blocks
from lintransunet_tpu_torch.models import (
    FLAGSHIP,
    MultiheadLinearAttention,
    flagship,
    get_model_dict,
    init_random_,
)
from lintransunet_tpu_torch.ops import attention
from lintransunet_tpu_torch.ops import conv_depthwise, conv_narrow
from lintransunet_tpu_torch.ops import conv_unit as cu
from lintransunet_tpu_torch.ops import conv_wgrad
from lintransunet_tpu_torch.ops import fused_stack as fs
from lintransunet_tpu_torch.ops import linear_attention as fused
from lintransunet_tpu_torch.utils import profiling

SEED = 0
VOLUME = (1, 1, 512, 512, 144)
N_VOLUMES = 3
WINDOWS_PER_VOLUME = 5      # depth 144, roi depth 64, overlap 0.6
KERNEL_NAMES = ("linear_attention", "conv_unit", "fused_stack", "conv_wgrad", "conv_narrow",
                "conv_depthwise", "probe_taps", "probe_conv", "probe_stats")
# The probes' tensor-core kernels whose registers and spills phase 1 prints
# on a line each: (library, kernel)
PROBE_MMA_KERNELS = (("probe_conv", "conv_mma"), ("probe_taps", "taps_fold"),
                     ("probe_taps", "taps_fold_weights"), ("probe_taps", "inner_taps"))


# The kernel wrappers whose calls the phases count: the port's kernels and
# the probes (on no path: every phase holds them at 0)
COUNTED = {"linear_attention": fused.linear_attention,
           "linear_attention_backward": fused.linear_attention_backward,
           "conv_unit": cu.conv_unit,
           "fused_stack": fs.fused_transformer_stack,
           "conv_wgrad": conv_wgrad.depthwise_weight_grad,
           "conv_narrow": conv_narrow.conv_narrow,
           "conv_depthwise": conv_depthwise.conv_depthwise,
           "tap_sum": dot_probe.tap_sum,
           "row_offset_sum": rowoffset_probe.row_offset_sum,
           "inner_step": inner_probe.inner_step_packed,
           "conv3d_cl": conv_prototype.conv3d_cl,
           "conv3d_cl_rows": conv_retired.conv3d_cl_rows,
           "lane_sums": in_stats_probe.lane_sums}


def _per(**counts):
    return {name: counts.get(name, 0) for name in COUNTED}


def times(per, n):
    return {name: count * n for name, count in per.items()}


# (C, O, (H, W, D)) of the five convolutions of a flagship forward on a
# 32-deep window that route to conv_narrow: the final block (the bottle
# model's one) and the mask heads of levels 0-3
NARROW_CALLS = [(16, 8, (256, 256, 32)), (32, 2, (256, 256, 32)), (64, 2, (128, 128, 32)),
                (128, 2, (64, 64, 16)), (256, 2, (32, 32, 16))]
# the positional encodings of a bf16 flagship forward, which route to
# conv_depthwise: the bottleneck's and the ROI bridges' at levels 3, 2, 1
PEG_CALLS = 4
# launches per window (serving) or pass of the train step's forward and
# backward through Python ("train": bf16, whose three 256-channel PEG
# weight gradients route to conv_wgrad; "train_f32": f32, which routes
# none). Every bf16 flagship forward at the phases' depths (32, 64) routes
# NARROW_CALLS to conv_narrow. On the card a micro-step is a graph replay:
# its kernels launch without Python, as the pass that captured them
# launched them, and the wrappers' counters count the passes alone
# (python_passes)
PER_WINDOW = {"default": _per(linear_attention=32, conv_narrow=len(NARROW_CALLS),
                              conv_depthwise=PEG_CALLS),
              "fused": _per(conv_unit=7, fused_stack=8, conv_narrow=len(NARROW_CALLS),
                            conv_depthwise=PEG_CALLS),
              "train": _per(linear_attention=32, linear_attention_backward=32, conv_wgrad=3,
                            conv_narrow=len(NARROW_CALLS), conv_depthwise=PEG_CALLS),
              "train_f32": _per(linear_attention=32, linear_attention_backward=32)}
# (BH, N, d) of the window's attention calls: bottleneck, levels 3, 2, 1
MAIN_SHAPES = [(8, 4096, 32), (8, 2160, 32), (8, 5376, 32), (4, 28704, 32)]
# the same on the 512 x 512 x 32 training patch (half the window's depth)
TRAIN_SHAPES = [(8, 2048, 32), (8, 1080, 32), (8, 2688, 32), (4, 14352, 32)]
# The window's four token stacks (N, C) in the fused configuration
STACK_SHAPES = [(4096, 256), (2160, 256), (5376, 256), (28704, 128)]
PATCH = (1, 1, 512, 512, 32)
LABEL_BOX = (slice(200, 320), slice(220, 300), slice(8, 24))  # bench.py:189-190
TRAIN_STEPS = 5
# epoch-0 deep-supervision weights (bench.py:199-203)
DYNAMIC_WEIGHT = engine.get_dynamic_weight(
    epochs=1, T=12.0, warmup_step=10, weight_list=(0.05, 0.05, 0.1, 0.1, 1.0),
    initial_weight=(0.1, 0.2, 0.3, 0.4, 1.0), final_weight=(2.0, 1.5, 1.0, 1.0, 1.0))[0]
# max |kernel - plain| <= tol * max |plain| for the two builds' ConnectBridge
# output and mask_list[0]. bf16: the kernel's few-ulp differences carried
# through 8 post-LN layers, one upsample and the mask conv (measured on an
# H100: 1.25e-2 and 8.0e-3). f32 with TF32 off: summation order only
# (measured: 8.7e-7 and 1.5e-6).
PRE_THRESHOLD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# The same two tensors, fused vs default configuration. bf16: the two
# configurations round to bf16 at different places in every conv of levels
# 0-1 and every layer of the stacks (measured on an H100: 2.3e-2). f32: the
# fused conv unit rounds its operands to bf16 (the JAX package's default)
# where the default path's cuDNN convs stay f32 (PERF.md holds the
# prediction and the measured value).
FUSED_TOL = {torch.float32: 5e-2, torch.bfloat16: 5e-2}
# Training, kernel vs plain attention, as a share of max |plain|, f32 (TF32
# off): the loss (relative), and each parameter's gradient: its largest
# difference over all parameters and the median. A weight gradient is an
# f32 sum over up to 2M voxels of terms that largely cancel, so any change
# at the rounding level moves it: on an H100 the same kernel build with
# PyTorch's and cuDNN's deterministic algorithms instead of the defaults
# moved the gradients by up to 9.8e-3 (median 4.1e-4), and kernel vs plain
# attention by up to 2.1e-2 (median 6.2e-4), with the loss equal to the bit
# (PERF.md has the run). Phase 8 measures such a floor beside the gate: the
# kernel build with every weight moved by 1e-7 relative. A gradient that
# vanishes in exact arithmetic
# (max |plain| below 1e-5 of the largest: biases ahead of an InstanceNorm,
# the key bias under the token softmax) is rounding noise and is held
# against a tenth of the largest gradient instead.
TRAIN_TOL = {"loss": 1e-5, "grad": 5e-2, "grad_median": 2e-3}
# bf16: the ConnectBridge gradients of the coarsest deep-supervision term
# alone, which flows through nothing downstream of the first ROI box.
UPSTREAM_GRAD_TOL = 5e-2
MIN_AGREEMENT = 0.999


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want):
    """(max |got - want|, that over max |want|) in f32."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err, (err / scale if scale else err)


def kernel_ptxas(name, kernel):
    """'<instance>: N registers, S bytes spill stores, L bytes spill loads' for
    each instance of ``kernel`` in library ``name``'s ptxas report."""
    found, current = [], None
    for line in kernels.build_log(name).splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            named = re.search(rf"{len(kernel)}{kernel}[IE]", entry.group(1))
            current = entry.group(1) if named else None
            if current:
                args = ",".join(re.findall(r"L[ib](\d+)E", current[named.end() - 1:]))
                found.append([f"{kernel}<{args}>" if args else kernel])
        elif current and ("spill" in line or "registers" in line):
            found[-1].append(line.split(":", 1)[-1].strip())
    return [" ".join(parts) for parts in found] or ["not in the build log"]


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    kernels.build_libraries(*KERNEL_NAMES)
    for name in KERNEL_NAMES:
        kernels.load(name)
    print(f"[card] {', '.join(KERNEL_NAMES)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in KERNEL_NAMES:
        ptxas = [line.strip() for line in kernels.build_log(name).splitlines()
                 if "entry function" in line or "registers" in line or "spill" in line]
        print(f"[card] {name} ptxas: {' | '.join(ptxas)}", flush=True)
    for name, kernel in PROBE_MMA_KERNELS:
        print(f"[card] {kernel} ptxas: {'; '.join(kernel_ptxas(name, kernel))}", flush=True)
    stack, smem = kernels.load("fused_stack"), ctypes.c_int()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, c in STACK_SHAPES:
        for apply in (0, 1):
            blocks = stack.fst_occupancy(c, apply, ctypes.byref(smem))
            if blocks < 1:
                fail(f"the bf16 stack kernel at C={c} fits no block on an SM ({blocks})")
            print(f"[card] fused_stack bf16 {'apply' if apply else 'kv'} kernel at N={n} "
                  f"C={c}: {stack.fst_num_tiles(n, 1)} blocks of 32 tokens, {smem.value} "
                  f"bytes of dynamic shared memory, {blocks} block(s) per SM on {sms} SMs",
                  flush=True)


# Phase 2: the card tests that hold each kernel's wrapper against its plain
# version at the model's shapes, and the bf16 flagship's graphed micro-steps,
# chosen by name (a new kernel's ``*_matches_plain`` test joins unlisted)
KERNEL_TESTS = ("tests/test_torch_cuda.py",
                "tests/test_torch_cuda_graphs.py::test_graphed_micro_steps_match_eager[flagship]")
KERNEL_TEST_NAMES = ("matches_plain or head_split or packed_qkv or narrow_heads "
                     "or bf16_operands or micro_steps_match_eager or depthwise_conv")


def phase_kernels():
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["--noconftest", "-q", "-p", "no:cacheprovider", "-k", KERNEL_TEST_NAMES,
                      *(os.path.join(REPO, path) for path in KERNEL_TESTS)])
    torch.cuda.empty_cache()
    if rc != 0:
        fail(f"2: the kernels' card tests returned {rc}")
    print(f"[kernels] phase 2 took {time.perf_counter() - t0:.1f} s", flush=True)


def build_model(attention_impl="kernel", dtype=torch.bfloat16, state=None,
                fused_config=False):
    return flagship(SEED, state, dtype=dtype, attention_impl=attention_impl,
                    fused_s1=fused_config, fused_stack=fused_config).eval()


def launch_counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


def python_passes():
    """The train steps' passes of the forward and backward through Python
    so far (eager micro-steps, warm-ups, captures) and their replays."""
    return engine.python_passes(), profiling.counts["step.replayed"]


def reset_launch_counts():
    for fn in COUNTED.values():
        fn.launches = 0


def phase_slice(model, volumes, path):
    """Serve ``volumes`` through ``make_eval_runner``; the kernels' launch
    counts must be PER_WINDOW[path] x windows."""
    _, runner = make_eval_runner(model, EvalConfig(roi_size=512, depth_size=64,
                                                   overlap=0.6, mode="constant"))
    reset_launch_counts()
    latencies, peaks = [], []
    for i, vol in enumerate(volumes):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = runner(vol)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        want_shape = (1, 2) + VOLUME[2:]
        if tuple(out.shape) != want_shape:
            fail(f"{path} volume {i}: output shape {tuple(out.shape)} != {want_shape}")
        if not torch.isfinite(out).all():
            fail(f"{path} volume {i}: non-finite output")
        sum_err = (out.sum(dim=1) - 1.0).abs().max().item()
        if sum_err > 1e-6 or out.min().item() < 0 or out.max().item() > 1:
            fail(f"{path} volume {i}: not a distribution over classes ({sum_err:.2e})")
        print(f"[{path}] volume {i}: {latencies[-1]:.3f} s, peak "
              f"{peaks[-1]:.2f} GiB, foreground share "
              f"{out[:, 1].mean().item():.4f}, |sum-1| {sum_err:.1e}", flush=True)
    launches = launch_counts()
    windows = WINDOWS_PER_VOLUME * len(volumes)
    want = {name: per * windows for name, per in PER_WINDOW[path].items()}
    print(f"[{path}] launches {launches} (want {want}); per-volume latency "
          f"{[round(s, 3) for s in latencies]} s", flush=True)
    if launches != want:
        fail(f"the {path} path launched {launches}, not {want}")


def pre_threshold(model, window):
    """(ConnectBridge output, mask_list[0]) of one window: everything the
    first ROI box is cut from."""
    bottleneck = getattr(model.decode, f"bridge_list_{model.decode.n_levels - 1}")
    seen = {}
    hook = bottleneck.register_forward_hook(lambda mod, i, out: seen.update(out=out))
    try:
        with torch.inference_mode():
            _, masks = model(window, return_aux=True)
    finally:
        hook.remove()
    return seen["out"], masks[0]


def compare_builds(label, first, second, window, dtype, tol):
    """Hold the two builds' pre-threshold tensors to ``tol``; return the
    share of foreground labels that agree and both window forward times."""
    name = str(dtype)[6:]
    for what, got, want in zip(("ConnectBridge output", "mask_list[0]"),
                               pre_threshold(first, window),
                               pre_threshold(second, window)):
        err, rel = rel_err(got, want)
        ok = rel <= tol[dtype]
        print(f"[{label}] {name} window, {what}: max_abs_err {err:.3e} rel "
              f"{rel:.3e} (tol {tol[dtype]:g}) {'ok' if ok else 'TOO FAR'}",
              flush=True)
        if not ok:
            fail(f"{label}: the builds disagree in {name} at the {what}")
    outs, times = [], []
    for m in (first, second):
        fwd = make_eval_forward(m)
        fwd(window)  # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(fwd(window))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (outs[0] == outs[1]).float().mean().item(), times


def phase_end_to_end(model, window):
    """Kernel vs plain attention on one window of the default path.

    The bf16 labels are printed, not held: the ROI foreground is cast to
    bf16 before its >= 0.5 threshold, so voxels sit exactly on it, a one-ulp
    difference moves a box by a pixel and the whole warped crop with it
    (PERF.md, Findings; ``tools/diag_bf16_threshold.py`` shows it)."""
    state = model.state_dict()
    for dtype in (torch.bfloat16, torch.float32):
        kern = model if dtype == torch.bfloat16 else build_model("kernel", dtype, state)
        plain = build_model("plain", dtype, state)
        agreement, times = compare_builds("e2e", kern, plain, window, dtype,
                                          PRE_THRESHOLD_TOL)
        held = (f"need >= {MIN_AGREEMENT * 100:.1f}%" if dtype == torch.float32
                else "informational")
        print(f"[e2e] {str(dtype)[6:]} window, kernel vs plain attention: "
              f"foreground labels agree on {agreement * 100:.4f}% of voxels "
              f"({held}); window {times[0]:.4f} s with the kernel, "
              f"{times[1]:.4f} s plain", flush=True)
        if dtype == torch.float32 and agreement < MIN_AGREEMENT:
            fail("kernel and plain builds disagree end to end in f32")


def phase_fused_vs_default(default, fused_model, window):
    """The fused configuration against the default one, same weights, on
    one window. The labels are informational in both dtypes: the fused conv
    rounds its operands to bf16 in an f32 model too, and the box threshold
    turns such differences into moved boxes (see ``phase_end_to_end``)."""
    state = default.state_dict()
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.bfloat16:
            pair = (fused_model, default)
        else:
            pair = (build_model("kernel", dtype, state, fused_config=True),
                    build_model("kernel", dtype, state))
        agreement, times = compare_builds("fused", *pair, window, dtype, FUSED_TOL)
        print(f"[fused] {str(dtype)[6:]} window, fused vs default configuration: "
              f"foreground labels agree on {agreement * 100:.4f}% of voxels "
              f"(informational: the fused conv rounds its operands to bf16); "
              f"window {times[0]:.4f} s fused, {times[1]:.4f} s default", flush=True)


def three_products(self, x, mask=None):
    """``MultiheadLinearAttention.forward`` as the JAX package's default
    path runs it: three projections, then the attention on their head-split
    views (the kernel for ``attention_impl="kernel"``). 4b's yardstick."""
    b, d_k = x.shape[0], self.d_model // self.nhead
    q, k, v = (getattr(self, f"linears_{i}")(x).view(b, -1, self.nhead, d_k).transpose(1, 2)
               for i in range(3))
    if mask is not None:
        out = attention.linear_attention(q, k, v, mask=mask[:, None])
    elif self.attention_impl == "kernel":
        out = fused.linear_attention(q, k, v)
    else:
        out = fused.linear_attention_reference(q, k, v)
    return self.linears_3(out.transpose(1, 2).reshape(b, -1, self.d_model))


@contextlib.contextmanager
def projection(fused_qkv):
    """Every ``MultiheadLinearAttention`` inside the block runs its own one
    QKV product (``fused_qkv``) or ``three_products``."""
    saved = MultiheadLinearAttention.forward
    if not fused_qkv:
        MultiheadLinearAttention.forward = three_products
    try:
        yield
    finally:
        MultiheadLinearAttention.forward = saved


def phase_fused_qkv(model, window):
    """4b: the default path's one QKV product against ``three_products``,
    same weights, on one window: held as phase 4 (upstream of the first ROI
    box within PRE_THRESHOLD_TOL in bf16 and f32, the f32 labels on
    MIN_AGREEMENT of the voxels), 32 attention launches, 5 conv_narrow
    and 4 conv_depthwise launches in bf16 (none in f32) and no other kernel's
    a window; the window's CUDA launches each way; then one f32
    train step (TF32 off), one product against three, within TRAIN_TOL, 32
    forward and 32 backward attention launches."""
    state = model.state_dict()
    for dtype in (torch.bfloat16, torch.float32):
        m = model if dtype == torch.bfloat16 else build_model("kernel", dtype, state)
        name = str(dtype)[6:]
        reset_launch_counts()
        got = pre_threshold(m, window)
        launches = launch_counts()
        # an f32 model routes no convolution to conv_narrow or conv_depthwise
        want = PER_WINDOW["default"] if dtype == torch.bfloat16 else dict(
            PER_WINDOW["default"], conv_narrow=0, conv_depthwise=0)
        if launches != want:
            fail(f"4b: a {name} window launched {launches}, not {want}")
        with projection(False):
            want = pre_threshold(m, window)
        for what, a, b in zip(("ConnectBridge output", "mask_list[0]"), got, want):
            err, rel = rel_err(a, b)
            ok = rel <= PRE_THRESHOLD_TOL[dtype]
            print(f"[fused_qkv] 4b {name} window, {what}, one QKV product vs three: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} (tol {PRE_THRESHOLD_TOL[dtype]:g}) "
                  f"{'ok' if ok else 'TOO FAR'}", flush=True)
            if not ok:
                fail(f"4b: one QKV product and three disagree in {name} at the {what}")
        fwd = make_eval_forward(m)
        outs, times, counts = [], [], []
        for fused_qkv in (True, False):
            with projection(fused_qkv):
                fwd(window)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs.append(fwd(window))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts.append(len(cuda_launches(lambda: fwd(window)).launches))
        agreement = (outs[0] == outs[1]).float().mean().item()
        held = f"need >= {MIN_AGREEMENT * 100:.1f}%" if dtype == torch.float32 else "informational"
        print(f"[fused_qkv] 4b {name} window: foreground labels agree on {agreement * 100:.4f}% "
              f"of voxels ({held}); window {times[0]:.4f} s with one QKV product, "
              f"{times[1]:.4f} s with three; CUDA launches per window {counts[0]} with one, "
              f"{counts[1]} with three", flush=True)
        if dtype == torch.float32 and agreement < MIN_AGREEMENT:
            fail("4b: one QKV product and three disagree end to end in f32")
        del m, fwd, outs
    torch.cuda.empty_cache()

    images, labels, criterions = train_inputs()
    reset_launch_counts()
    one = train_step_grads("kernel", torch.float32, images, labels, criterions)
    launches = launch_counts()
    with projection(False):
        three = train_step_grads("kernel", torch.float32, images, labels, criterions)
    if launches != PER_WINDOW["train_f32"]:
        fail(f"4b: a train step launched {launches}, not {PER_WINDOW['train_f32']}")
    loss_rel, worst, median = compare_steps("float32 step, one QKV product vs three", one, three)
    ok = (loss_rel <= TRAIN_TOL["loss"] and worst <= TRAIN_TOL["grad"]
          and median <= TRAIN_TOL["grad_median"])
    print(f"[fused_qkv] 4b float32 step: tol loss {TRAIN_TOL['loss']:g}, gradients "
          f"{TRAIN_TOL['grad']:g}, median {TRAIN_TOL['grad_median']:g} "
          f"{'ok' if ok else 'TOO FAR'}", flush=True)
    if not ok:
        fail("4b: one QKV product and three disagree in a float32 train step")
    del one, three, images, labels
    torch.cuda.empty_cache()


def train_inputs():
    """The training patch, its labels and the criterion schedule."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    images = torch.randn(PATCH, generator=gen).to("cuda")
    labels = torch.zeros((PATCH[0],) + PATCH[2:], dtype=torch.long, device="cuda")
    labels[(slice(None),) + LABEL_BOX] = 1
    criterions, _ = get_criterion_list(5, ["CrossEntroLoss", "DiceClassLoss"])
    return images, labels, criterions


def dropout_generator():
    return torch.Generator(device="cuda").manual_seed(SEED + 6)


def grads_finite(model):
    """A device flag: every parameter's gradient is finite (no sync)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    return torch.isfinite(torch.stack(torch._foreach_norm(grads))).all()


def phase_train(images, labels, criterions):
    """TRAIN_STEPS timed train steps of the bf16 flagship after a warm one;
    returns the step's ms."""
    model = build_model().train()
    state = engine.create_train_state(model, learning_rate=1e-4)
    step = engine.make_train_step(model, criterions)
    gen = dropout_generator()
    n_params = sum(p.numel() for p in model.parameters())

    # the shapes of the warm step's kernel calls (the backward's are the
    # forward's: it takes the saved q, k, v)
    seen = set()
    forward = fused._forward_kernel

    def recording(q, k, v):
        seen.add((q.shape[0] * q.shape[1],) + tuple(q.shape[2:]))
        return forward(q, k, v)

    reset_launch_counts()
    passes = [python_passes()]
    fused._forward_kernel = recording
    try:
        loss, _ = step(state, images, labels, DYNAMIC_WEIGHT, gen)
    finally:
        fused._forward_kernel = forward
    finite = torch.isfinite(loss) & grads_finite(model)
    per_step = [launch_counts()]
    passes.append(python_passes())
    print(f"[train] attention shapes (BH, N, d) of the training patch: "
          f"{sorted(seen, key=lambda t: -t[1])}", flush=True)
    if seen != set(TRAIN_SHAPES):
        fail(f"the training patch's attention shapes {sorted(seen)} are not {TRAIN_SHAPES}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        before = launch_counts()
        loss, logs = step(state, images, labels, DYNAMIC_WEIGHT, gen)
        finite = finite & torch.isfinite(loss) & grads_finite(model)
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
        passes.append(python_passes())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = launch_counts()
    if not bool(finite):
        fail("a train step gave a non-finite loss or gradient")
    # (passes through Python, replays) of each step: the first warms up and
    # captures, each replays once
    steps = [(b[0] - a[0], b[1] - a[1]) for a, b in zip(passes, passes[1:])]
    if steps != [(2, 1)] + [(0, 1)] * TRAIN_STEPS:
        fail(f"the train steps' (passes through Python, replays) were {steps}")
    if any(c != times(PER_WINDOW["train"], n) for c, (n, _) in zip(per_step, steps)):
        fail(f"train steps launched {per_step}, not {PER_WINDOW['train']} a pass of {steps}")
    replay = replay_kernels(lambda: step(state, images, labels, DYNAMIC_WEIGHT, gen))
    print(f"[train] {TRAIN_STEPS + 1} steps of the flagship ({n_params:,} f32 "
          f"parameters, bf16 compute) on a {'x'.join(map(str, PATCH[2:]))} patch: "
          f"{ms:.2f} ms per step (mean of {TRAIN_STEPS}, one synchronise), peak "
          f"{peak:.2f} GiB; last loss {loss.item():.6f}; step {state.step}, "
          f"optimizer updates {state.gradient_step}; launches {launches} (the first step "
          f"warms up and captures, the others replay)", flush=True)
    print(f"[train] one replayed step's device rows of the port's kernels: {replay} (of "
          f"{REPLAY_ROWS} launched)", flush=True)
    print(f"[train] last step's logs: "
          f"{ {k: round(v.item(), 6) for k, v in logs.items()} }", flush=True)
    return ms


# device rows of one replayed bf16 micro-step of the flagship, by kernel
# name: 32 attention calls each way (lta_fold in both, then lta_out or
# lta_bwd_tokens), three routed weight gradients (two launches each) and
# the four positional encodings' forwards
REPLAY_ROWS = {"lta_fold": 64, "lta_out": 32, "lta_bwd_tokens": 32,
               "conv_unit_wgrad_dw": 3, "conv_unit_wgrad_sum": 3, "conv_unit_depthwise": 4}


def replay_kernels(fn):
    """{kernel: device rows} of the port's kernels in one call of ``fn`` (a
    replayed micro-step) under the profiler; fails unless each kernel shows
    and none more often than a replay launches it (the profiler now and
    then drops a device row, so fewer can show)."""
    _, _, rows = cuda_launches(fn)
    found = {name: sum(1 for row in rows if re.search(rf"\b{name}\b", row))
             for name in REPLAY_ROWS}
    if not all(0 < found[name] <= want for name, want in REPLAY_ROWS.items()):
        fail(f"a replayed train step showed {found} of the port's kernels, not up to "
             f"{REPLAY_ROWS} with each present")
    return found


def move_weights_(model, jitter):
    """Move each weight by ``jitter`` relative (a seeded normal): a
    rounding-level change whose effect on a step is the step's floor."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + jitter * torch.randn(p.shape, generator=gen).to(p.device))
    return model


def train_step_grads(attention_impl, dtype, images, labels, criterions,
                     dynamic_weight=DYNAMIC_WEIGHT, jitter=0.0):
    """(loss, {name: gradient}) of one train step from the seed's weights,
    each weight moved by ``jitter`` relative (seeded normal) if given."""
    model = build_model(attention_impl, dtype).train()
    if jitter:
        move_weights_(model, jitter)
    step = engine.make_train_step(model, criterions)
    loss, _ = step.loss_fn(images, labels, dynamic_weight, dropout_generator())
    loss.backward()
    grads = {name: p.grad.float() for name, p in model.named_parameters()}
    return loss.item(), grads


def grad_errors(got, want):
    """{name: max |got - want| over max |want|}; a gradient below 1e-5 of
    the largest is held against a tenth of the largest (TRAIN_TOL)."""
    top = max(w.abs().max().item() for w in want.values())
    errors = {}
    for name, w in want.items():
        scale = w.abs().max().item()
        errors[name] = (got[name] - w).abs().max().item() / (
            scale if scale >= 1e-5 * top else 1e-1 * top)
    return errors


def compare_steps(label, got, want):
    """(loss rel, largest gradient difference, median) of two steps, printed."""
    loss_rel = abs(got[0] - want[0]) / abs(want[0])
    errors = grad_errors(got[1], want[1])
    worst = max(errors.items(), key=lambda kv: kv[1])
    median = sorted(errors.values())[len(errors) // 2]
    print(f"[train e2e] {label}: loss rel {loss_rel:.3e}, gradients within "
          f"{worst[1]:.3e} of max |plain| (at {worst[0]}), median over "
          f"{len(errors)} parameters {median:.3e}", flush=True)
    return loss_rel, worst[1], median


def phase_train_vs_plain(images, labels, criterions):
    """Kernel vs plain attention on one train step of the same weights,
    batch and dropout generator; f32 held, bf16 printed; then the bf16
    gradients upstream of the first ROI box held."""
    kern = train_step_grads("kernel", torch.float32, images, labels, criterions)
    plain = train_step_grads("plain", torch.float32, images, labels, criterions)
    moved = train_step_grads("kernel", torch.float32, images, labels, criterions,
                             jitter=1e-7)
    compare_steps("float32 step, kernel build with its weights moved by 1e-7 "
                  "relative vs as built (the rounding-level floor)", moved, kern)
    loss_rel, worst, median = compare_steps(
        "float32 step, kernel vs plain attention", kern, plain)
    del kern, plain, moved
    torch.cuda.empty_cache()
    ok = (loss_rel <= TRAIN_TOL["loss"] and worst <= TRAIN_TOL["grad"]
          and median <= TRAIN_TOL["grad_median"])
    print(f"[train e2e] float32: tol loss {TRAIN_TOL['loss']:g}, gradients "
          f"{TRAIN_TOL['grad']:g}, median {TRAIN_TOL['grad_median']:g} "
          f"{'ok' if ok else 'TOO FAR'}", flush=True)
    if not ok:
        fail("kernel and plain attention train steps disagree in float32")
    compare_steps("bfloat16 step, kernel vs plain attention (informational: "
                  "the bf16 box threshold moves boxes)",
                  train_step_grads("kernel", torch.bfloat16, images, labels, criterions),
                  train_step_grads("plain", torch.bfloat16, images, labels, criterions))
    torch.cuda.empty_cache()

    # bf16, upstream of the first ROI box: the coarsest mask's term alone
    only_coarsest = [0.0] * (len(DYNAMIC_WEIGHT) - 1) + [DYNAMIC_WEIGHT[-1]]
    kern, plain = (train_step_grads(impl, torch.bfloat16, images, labels, criterions,
                                    only_coarsest) for impl in ("kernel", "plain"))
    prefix = "decode.bridge_list_4."
    errors = grad_errors({k: v for k, v in kern[1].items() if k.startswith(prefix)},
                         {k: v for k, v in plain[1].items() if k.startswith(prefix)})
    worst = max(errors.items(), key=lambda kv: kv[1])
    ok = worst[1] <= UPSTREAM_GRAD_TOL
    print(f"[train e2e] bf16, the coarsest mask's term alone: ConnectBridge "
          f"gradients ({len(errors)} parameters) within {worst[1]:.3e} of max "
          f"|plain| at {worst[0]} (tol {UPSTREAM_GRAD_TOL:g}); loss rel "
          f"{abs(kern[0] - plain[0]) / abs(plain[0]):.3e} {'ok' if ok else 'TOO FAR'}",
          flush=True)
    if not ok:
        fail("kernel and plain attention disagree upstream of the first ROI box in bf16")


# Phase 10: the binary CLIs at full width on a synthetic workspace of
# CLI_PATIENTS volumes of CLI_SHAPE (D, H, W) HU values, N(40, 60), each with
# a pancreas-sized label blob (CLI_BLOB, fractions of each axis)
CLI_PATIENTS = 4
CLI_SHAPE = (80, 512, 512)
CLI_BLOB = ((0.375, 0.625), (0.43, 0.57), (0.39, 0.625))
# phase 11's class-2 blob, beside the class-1 one along W
CLI_BLOB2 = ((0.375, 0.625), (0.57, 0.64), (0.39, 0.625))
MONAI_FLAGS = ("--image_crop", "512", "--depth_size", "32", "--batch_size", "1",
               "--epochs", "1", "--eval_epoch", "1", "--compute_dtype", "bfloat16")
CLI_TRAIN_FLAGS = ("--image_crop", "512", "--depth_size", "32", "--num_samples", "3",
                   "--batch_size", "1", "--epochs", "1", "--eval_epoch", "1",
                   "--is_transform", "true", "--compute_dtype", "bfloat16")
CLI_INFER_FLAGS = ("--roi_size", "512", "--depth_size", "64", "--overlap", "0.6",
                   "--is_save", "true")


@contextlib.contextmanager
def command_line(args):
    """``sys.argv`` as a user's command line would set it."""
    saved = sys.argv
    sys.argv = ["chip_smoke"] + list(args)
    try:
        yield
    finally:
        sys.argv = saved


@contextlib.contextmanager
def timed(owner, name, log, generator=False):
    """Time every call of ``owner.name`` (host wall time) into ``log``. For a
    generator, time each item from the request to the consumer's next
    request, so that the consumer's own work on the item counts."""
    original = getattr(owner, name)

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return original(*args, **kwargs)
        finally:
            log.append(time.perf_counter() - t0)

    def each(*args, **kwargs):
        t0 = time.perf_counter()
        for item in original(*args, **kwargs):
            yield item
            log.append(time.perf_counter() - t0)
            t0 = time.perf_counter()

    setattr(owner, name, each if generator else call)
    try:
        yield
    finally:
        setattr(owner, name, original)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def cli_workspace(root, shape, patients, multi_class=False):
    """image/ and label/ .npy volumes under ``root``/data (with
    ``multi_class``, a class-2 blob beside each class-1 one), and a 2-fold
    split written by the port's split tool; returns (data dir, split path)."""
    data_dir = os.path.join(root, "data")
    rng = np.random.default_rng(SEED + 8)
    blobs = [tuple(slice(int(lo * n), int(hi * n)) for (lo, hi), n in zip(box, shape))
             for box in ((CLI_BLOB, CLI_BLOB2) if multi_class else (CLI_BLOB,))]
    for sub in ("image", "label"):
        os.makedirs(os.path.join(data_dir, sub))
    for i in range(patients):
        label = np.zeros(shape, np.uint8)
        for value, blob in enumerate(blobs, start=1):
            label[blob] = value
        np.save(os.path.join(data_dir, "image", f"{i:04d}.npy"),
                rng.normal(40.0, 60.0, shape).astype(np.float32))
        np.save(os.path.join(data_dir, "label", f"{i:04d}.npy"), label)
    split = os.path.join(root, "split.json")
    with command_line(["--dir_data", data_dir, "--k_folds", "2", "--out", split]), \
            contextlib.redirect_stdout(io.StringIO()):
        split_dataset.main()
    return data_dir, split


def _windows(volume_hwd, roi, overlap):
    """Windows of the runner's own grid over one (H, W, D) volume."""
    return len(dense_window_starts(padded_spatial_shape(volume_hwd, roi), roi, overlap))


def _train_dataset(ds):
    return isinstance(ds, data.IdPosPanCTDataset) or (
        isinstance(ds, data.CachePanDataset) and ds.train)


@contextlib.contextmanager
def train_waits(waits):
    """Append to ``waits`` the host time the train loop waits for each batch
    of a training dataset's loader."""
    loader_iter = data.DataLoader.__iter__

    def each(loader):
        it = loader_iter(loader)
        train = _train_dataset(loader.dataset)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                return
            if train:
                waits.append(time.perf_counter() - t0)
            yield batch

    data.DataLoader.__iter__ = each
    try:
        yield
    finally:
        data.DataLoader.__iter__ = loader_iter


def run_cli_path(root, shape, patients, train_flags, infer_flags, multi_class=False):
    """``train3d`` then ``inference_embed_attn`` on the checkpoint it wrote
    (``multi_class``: ``train3d_multi_class`` then
    ``inference_multi_classes``), each through its parser as a user runs
    it, with the launch counts set to 0 just before each and read just
    after; returns what phases 10 and 11 hold and print."""
    train_cli = train3d_multi_class if multi_class else train3d
    infer_cli = inference_multi_classes if multi_class else inference_embed_attn
    data_dir, split = cli_workspace(root, shape, patients, multi_class)
    train_ids, test_ids = data.load_fold(split, 0)
    out = {"epoch_s": [], "eval_s": [], "waits": [], "items": [], "volume_s": [],
           "data_dir": data_dir, "split": split}
    train_argv = ["--dir_data", data_dir, "--split_json", split, "--fold_num", "0",
                  "--log_dir", os.path.join(root, "runs"),
                  "--model_dir", os.path.join(root, "out"), *train_flags]
    with command_line(train_argv):
        args = train_cli.get_parse()
    with timed(loop, "train_on_epoch", out["epoch_s"]), \
            timed(loop, "eval_on_epoch", out["eval_s"]), \
            timed(data.IdPosPanCTDataset, "__getitem__", out["items"]), \
            train_waits(out["waits"]):
        reset_launch_counts()
        before = python_passes()
        train_cli.main(args)
        _sync()
        out["train_launches"] = launch_counts()
        out["passes"], out["replays"] = (b - a for a, b in zip(before, python_passes()))
    eval_roi = (args.image_crop, args.image_crop, args.eval_depth)
    out["eval_windows"] = sum(_windows(shape[1:] + shape[:1], eval_roi, EvalConfig().overlap)
                              for _ in test_ids)
    out["eval_volumes"] = len(test_ids)

    run_dir = os.path.join(root, "out", os.listdir(os.path.join(root, "out"))[0])
    out["artifacts"] = sorted(os.listdir(os.path.join(run_dir, "fold_0")))
    out["state"] = torch.load(os.path.join(run_dir, "fold_0", "train_state"),
                              map_location="cpu", weights_only=True)
    logs = [os.path.join(d, f) for d, _, files in os.walk(os.path.join(root, "runs"))
            for f in files if f == "metrics.jsonl"]
    out["records"] = [json.loads(line) for line in open(logs[0])]

    infer_argv = ["--dir_data", data_dir, "--split_json", split, "--pretrained_dir", run_dir,
                  "--saved_folder", os.path.join(root, "pred"), *infer_flags]
    with command_line(infer_argv):
        iargs = infer_cli.get_parse()
    cwd = os.getcwd()
    os.chdir(root)  # the CLI writes summary_4_fold.json where it runs
    try:
        with timed(common, "batched_predictions", out["volume_s"], generator=True):
            reset_launch_counts()
            t0 = time.perf_counter()
            infer_cli.main(iargs)
            _sync()
            out["infer_s"] = time.perf_counter() - t0
            out["infer_launches"] = launch_counts()
    finally:
        os.chdir(cwd)
    roi = (iargs.roi_size, iargs.roi_size, iargs.depth_size)
    out["infer_chunks"] = sum(math.ceil(_windows(shape[1:] + shape[:1], roi, iargs.overlap)
                                        / iargs.sw_batch_size) for _ in test_ids[:-1])
    out["served"] = len(test_ids) - 1
    out["summary"] = json.load(open(os.path.join(root, "summary_4_fold.json")))
    out["exports"] = [np.load(os.path.join(root, "pred", f))
                      for f in sorted(os.listdir(os.path.join(root, "pred")))]
    out["patients"] = len(train_ids)
    out["num_samples"] = args.num_samples
    return out


def native_vs_numpy(shape):
    """Host ms of the native HU window and of its numpy fallback on one
    volume of ``shape`` (best of 3 each, in turns native, numpy, numpy,
    native ...); None where the library did not load. Fails unless both
    give the same bits."""
    if not native.AVAILABLE:
        return None
    vol = np.random.default_rng(SEED + 9).normal(40.0, 60.0, shape).astype(np.float32)
    window = (-91.0, 250.0, 86.9, 39.4)  # IdPosPanCTDataset's
    fns = (native.hu_window_normalize, native.hu_window_normalize_numpy)
    if not np.array_equal(fns[0](vol, *window), fns[1](vol, *window)):
        fail("the native HU window and its numpy fallback disagree")
    times = ([], [])
    for _ in range(3):
        for i in (0, 1, 1, 0):
            t0 = time.perf_counter()
            fns[i](vol, *window)
            times[i].append((time.perf_counter() - t0) * 1e3)
    return min(times[0]), min(times[1])


def narrow_calls(classes):
    """The flagship's forward's convolutions that route to conv_narrow at
    the phases' depths: the final block (4 outputs a class) where it has at
    most 8 outputs, and the four mask heads (one a class)."""
    out = conv_narrow.MAX_OUT
    return int(4 * classes <= out) + 4 * int(classes <= out)


def train_launches(passes, eval_windows, classes=2):
    """The kernels' launches in a bf16 train3d run: each pass of the step's
    forward and backward through Python (the replays launch none there) and
    each eval window's forward."""
    per = times(PER_WINDOW["train"], passes)
    per["linear_attention"] += PER_WINDOW["default"]["linear_attention"] * eval_windows
    per["conv_narrow"] = narrow_calls(classes) * (passes + eval_windows)
    per["conv_depthwise"] = PEG_CALLS * (passes + eval_windows)
    return per


def check_cli_run(tag, out, multi_class=False):
    """Phase 10's and 11's gates on one train + inference run; returns the
    number of train steps."""
    train_name = "train3d_multi_class" if multi_class else "train3d"
    infer_name = "inference_multi_classes" if multi_class else "inference_embed_attn"
    steps = out["patients"] * out["num_samples"]
    if out["state"]["step"] != steps or out["replays"] != steps:
        fail(f"{train_name} took {out['state']['step']} steps, {out['replays']} replayed, "
             f"not {steps}")
    classes = 3 if multi_class else 2
    want = train_launches(out["passes"], out["eval_windows"], classes)
    if out["train_launches"] != want:
        fail(f"{train_name} launched {out['train_launches']}, not {want} ({out['passes']} "
             f"passes through Python for {steps} steps, and {out['eval_windows']} eval windows)")
    want_infer = _per(linear_attention=32 * out["infer_chunks"],
                      conv_narrow=narrow_calls(classes) * out["infer_chunks"],
                      conv_depthwise=PEG_CALLS * out["infer_chunks"])
    if out["infer_launches"] != want_infer:
        fail(f"{infer_name} launched {out['infer_launches']}, not {want_infer} "
             f"({out['infer_chunks']} window batches)")
    tags = {r["tag"] for r in out["records"]}
    need = {"train/total_loss", "eval/DiceClassLoss"} | (
        {"eval/DiceClassLoss2"} if multi_class else set())
    if not need <= tags:
        fail(f"{tag}: metrics.jsonl lacks one of {sorted(need)}: {sorted(tags)}")
    if not all(math.isfinite(r["value"]) for r in out["records"]):
        fail(f"{train_name} logged a non-finite value")
    if not {"temp_model", "train_state", "model"} <= set(out["artifacts"]):
        fail(f"{train_name} wrote {out['artifacts']}")
    values = {0, 1, 2} if multi_class else {0.0, 1.0}
    if len(out["exports"]) != out["served"] or any(
            e.shape != CLI_SHAPE or not set(np.unique(e).tolist()) <= values
            or (multi_class and e.dtype != np.uint8) for e in out["exports"]):
        fail(f"exports {[(e.shape, e.dtype, np.unique(e)[:4]) for e in out['exports']]}, "
             f"want {out['served']} {CLI_SHAPE} with values in {sorted(values)}")
    summary = [v for key, vs in out["summary"].items() for v in np.ravel(vs)]
    if not summary or not all(math.isfinite(v) for v in summary):
        fail(f"summary_4_fold.json is not finite: {out['summary']}")
    return steps


def print_cli_run(tag, out, steps, train_ms, multi_class=False):
    train_name = "train3d_multi_class" if multi_class else "train3d"
    infer_name = "inference_multi_classes" if multi_class else "inference_embed_attn"
    train_s = sum(out["epoch_s"])
    losses = [round(r["value"], 6) for r in out["records"] if r["tag"] == "train/total_loss"]
    evals = {r["tag"]: round(r["value"], 6) for r in out["records"] if r["tag"].startswith("eval/")}
    print(f"[{tag}] {train_name} at full width ({CLI_PATIENTS} volumes of {CLI_SHAPE} "
          f"(D, H, W), fold 0: {out['patients']} train patients x {out['num_samples']} steps, "
          f"{out['eval_windows']} eval windows): launches {out['train_launches']}; "
          f"patient losses {losses}; eval {evals}; artifacts {out['artifacts']}", flush=True)
    print(f"[{tag}] {train_name} time: {train_s / steps * 1e3:.2f} ms per step through the "
          f"CLI ({steps} steps in {train_s:.3f} s, data waits included) against phase 7's "
          f"{train_ms:.2f} ms per step; the loop waited {sum(out['waits']):.3f} s for "
          f"batches ({[round(w, 3) for w in out['waits']]} s), the workers spent "
          f"{[round(s, 3) for s in out['items']]} s preparing each patient; eval "
          f"{out['eval_s'][0]:.3f} s for {out['eval_windows']} windows over "
          f"{out['eval_volumes']} volumes ({out['eval_s'][0] / out['eval_volumes']:.3f} s "
          f"per volume, the first forwards' warm-up included); native "
          f"preprocessing core {'loaded' if native.AVAILABLE else 'NOT loaded (numpy fallback)'}",
          flush=True)
    print(f"[{tag}] {infer_name}: {out['served']} volume(s) served, "
          f"{[round(s, 3) for s in out['volume_s']]} s per served volume (load, "
          f"{out['infer_chunks']} window batch(es), metrics, export), {out['infer_s']:.3f} s "
          f"in all with the model's build; launches {out['infer_launches']}; export "
          f"{[(e.shape, str(e.dtype), np.unique(e).tolist()) for e in out['exports']]}; "
          f"summary {out['summary']}", flush=True)


def phase_cli(train_ms):
    """Phase 10: the binary CLIs at full width; returns ``train3d``'s ms
    per step."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        out = run_cli_path(root, CLI_SHAPE, CLI_PATIENTS, CLI_TRAIN_FLAGS, CLI_INFER_FLAGS)
        total_s = time.perf_counter() - t0
    steps = check_cli_run("cli", out)
    print_cli_run("cli", out, steps, train_ms)
    hu_shape = CLI_SHAPE[1:] + CLI_SHAPE[:1]
    hu = native_vs_numpy(hu_shape)
    print(f"[cli] HU window on one {hu_shape} volume: " + (
        "native core not loaded" if hu is None else
        f"native {hu[0]:.3f} ms, numpy fallback {hu[1]:.3f} ms (same bits; host time, "
        f"best of 3)"), flush=True)
    print(f"[cli] phase 10 took {total_s:.1f} s", flush=True)
    return sum(out["epoch_s"]) / steps * 1e3


def run_monai(root, data_dir, split):
    """``train3d_monai_version`` through its parser on phase 11's workspace:
    the cached pipeline (resampled to 0.5 x 0.5 x 2 mm and oriented, as its
    defaults do), one step a batch, one epoch with its eval; returns what
    phase 11 holds and prints."""
    out = {"eval_s": [], "waits": [], "eval_shapes": []}
    argv = ["--dir_data", data_dir, "--split_json", split, "--fold_num", "0",
            "--log_dir", os.path.join(root, "monai_runs"),
            "--model_dir", os.path.join(root, "monai_out"), *MONAI_FLAGS]
    with command_line(argv):
        args = train3d_monai_version.get_parse()
    item = data.CachePanDataset.__getitem__

    def eval_item(self, index):  # the eval volumes' shapes, for the window count
        got = item(self, index)
        if not self.train:
            out["eval_shapes"].append(got[0].shape[1:4])
        return got

    data.CachePanDataset.__getitem__ = eval_item
    try:
        with timed(loop, "eval_on_epoch", out["eval_s"]), train_waits(out["waits"]):
            reset_launch_counts()
            before = python_passes()
            t0 = time.perf_counter()
            train3d_monai_version.main(args)
            _sync()
            out["s"] = time.perf_counter() - t0
            out["launches"] = launch_counts()
            out["passes"], out["replays"] = (b - a for a, b in zip(before, python_passes()))
    finally:
        data.CachePanDataset.__getitem__ = item
    run_dir = os.path.join(root, "monai_out", os.listdir(os.path.join(root, "monai_out"))[0])
    out["artifacts"] = sorted(os.listdir(os.path.join(run_dir, "fold_0")))
    out["state"] = torch.load(os.path.join(run_dir, "fold_0", "train_state"),
                              map_location="cpu", weights_only=True)
    logs = [os.path.join(d, f) for d, _, files in os.walk(os.path.join(root, "monai_runs"))
            for f in files if f == "metrics.jsonl"]
    out["records"] = [json.loads(line) for line in open(logs[0])]
    roi = (args.image_crop, args.image_crop, args.eval_depth)
    out["eval_windows"] = sum(_windows(tuple(shape), roi, EvalConfig().overlap)
                              for shape in out["eval_shapes"])
    out["train_patients"] = len(data.load_fold(split, 0)[0])
    return out


def phase_multi_class_cli(train_ms):
    """Phase 11: the three multi-class CLIs at full width on phase 10's
    workspace with a class-2 blob: ``train3d_multi_class``, then
    ``inference_multi_classes`` on its checkpoint, then
    ``train3d_monai_version``."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        out = run_cli_path(root, CLI_SHAPE, CLI_PATIENTS, CLI_TRAIN_FLAGS, CLI_INFER_FLAGS,
                           multi_class=True)
        steps = check_cli_run("multi", out, multi_class=True)
        print_cli_run("multi", out, steps, train_ms, multi_class=True)
        monai = run_monai(root, out["data_dir"], out["split"])
        total_s = time.perf_counter() - t0
    monai_steps = monai["train_patients"]  # batch 1, one sample a patient
    if monai["state"]["step"] != monai_steps or monai["replays"] != monai_steps:
        fail(f"train3d_monai_version took {monai['state']['step']} steps, {monai['replays']} "
             f"replayed, not {monai_steps}")
    want = train_launches(monai["passes"], monai["eval_windows"], classes=3)
    if monai["launches"] != want:
        fail(f"train3d_monai_version launched {monai['launches']}, not {want} "
             f"({monai['passes']} passes through Python for {monai_steps} steps, and "
             f"{monai['eval_windows']} eval windows)")
    tags = {r["tag"] for r in monai["records"]}
    if not {"train/total_loss", "eval/DiceClassLoss2"} <= tags or not all(
            math.isfinite(r["value"]) for r in monai["records"]):
        fail(f"train3d_monai_version's metrics.jsonl: {monai['records']}")
    if not {"temp_model", "train_state", "model"} <= set(monai["artifacts"]):
        fail(f"train3d_monai_version wrote {monai['artifacts']}")
    evals = {r["tag"]: round(r["value"], 6) for r in monai["records"]
             if r["tag"].startswith("eval/")}
    print(f"[multi] train3d_monai_version at full width (the same {CLI_PATIENTS} volumes "
          f"resampled to 0.5 x 0.5 x 2 mm and oriented; eval volumes "
          f"{[tuple(x) for x in monai['eval_shapes']]} (H, W, D), {monai['eval_windows']} "
          f"eval windows; {monai_steps} steps of one batch): launches {monai['launches']}; "
          f"{monai['s']:.3f} s in all with the cache's preparation and the model's build, "
          f"eval {monai['eval_s'][0]:.3f} s, the loop waited "
          f"{[round(w, 3) for w in monai['waits']]} s for its batches; eval {evals}; "
          f"artifacts {monai['artifacts']}; phase 11 took {total_s:.1f} s", flush=True)


# Phase 12: the four other models of Model_Dict at the flagship's widths
OTHER_MODELS = ("TraditionUnet", "BottleTransUnet", "SkipTransUnet", "MaskSkipTransUnet")
WIDTHS = dict(num_layers=FLAGSHIP["num_layers"], dim_input=1, dim_output=2)
WINDOW = (1, 1, 512, 512, 64)


def build_other(name, attention_impl="kernel", dtype=torch.bfloat16, state=None):
    model = get_model_dict(name)(**WIDTHS, dtype=dtype, attention_impl=attention_impl)
    if state is None:
        init_random_(model, torch.Generator(device="cpu").manual_seed(SEED))
    else:
        model.load_state_dict(state)
    return model.eval()


def attention_layers(model):
    """The model's attention layers: each runs once a forward, unmasked."""
    return sum(isinstance(m, MultiheadLinearAttention) for m in model.modules())


def model_forward(model, window):
    """(probabilities, masks or None, the bottleneck bridge's output or None)
    of an eval forward."""
    bridge = getattr(model, "connect_bridge", None)
    if bridge is not None and hasattr(bridge, "n_levels"):  # MaskSkipTransUnet's Bridge
        bridge = getattr(bridge, f"bridge_list_{bridge.n_levels - 1}")
    seen = {}
    hook = bridge.register_forward_hook(lambda m, i, o: seen.update(out=o)) if bridge else None
    try:
        with torch.inference_mode():
            out = model(window)
    finally:
        if hook:
            hook.remove()
    out, masks = out if isinstance(out, tuple) else (out, None)
    return out, masks, seen.get("out")


def routed_calls(model, fn):
    """(``fn()``, {"conv_narrow": n, "conv_depthwise": m}: the calls in it
    of the model's ``Conv3d`` layers that each wrapper's ``routes`` takes)."""
    calls = {"conv_narrow": 0, "conv_depthwise": 0}

    def count(mod, args):
        for name, op in (("conv_narrow", conv_narrow), ("conv_depthwise", conv_depthwise)):
            calls[name] += op.routes(args[0], mod.weight, mod.stride, mod.padding, mod.groups)

    handles = [m.register_forward_pre_hook(count) for m in model.modules()
               if isinstance(m, blocks.Conv3d)]
    try:
        return fn(), calls
    finally:
        for handle in handles:
            handle.remove()


def phase_other_models(window):
    """Each of the four models on one window in bf16 with the kernel: shape,
    finite channel probabilities, exact launches (the attention kernel once a
    layer, conv_narrow and conv_depthwise once a routed convolution: the
    bottle model's final block and its positional encoding alone); then
    kernel vs plain in f32 on the same window."""
    for name in OTHER_MODELS:
        model = build_other(name)
        model_forward(model, window)  # warm up
        _sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        (out, masks, _), routed = routed_calls(model, lambda: model_forward(model, window))
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        want = _per(linear_attention=attention_layers(model), **routed)
        if routed["conv_narrow"] < 1 or (name == "BottleTransUnet"
                                         and routed != {"conv_narrow": 1, "conv_depthwise": 1}):
            fail(f"{name}: convolutions routed {routed}")
        if tuple(out.shape) != (1, 2) + WINDOW[2:] or not torch.isfinite(out).all():
            fail(f"{name}: output {tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}")
        sum_err = (out.sum(dim=1) - 1.0).abs().max().item()
        if sum_err > 1e-5:
            fail(f"{name}: channels sum to 1 within {sum_err:.2e} only")
        if launches != want:
            fail(f"{name} launched {launches}, not {want}")
        state = model.state_dict()
        del model
        msg = (f"[models] {name} bf16 window: {ms:.2f} ms, launches "
               f"{launches['linear_attention']} ({want['linear_attention']} attention layers), "
               f"|sum-1| {sum_err:.1e}, foreground share {out[:, 1].mean().item():.4f}")
        if masks is not None:
            msg += f", masks {[tuple(m.shape) for m in masks]}"
        print(msg, flush=True)
        if not want["linear_attention"]:
            print(f"[models] {name} has no attention: kernel and plain builds are one",
                  flush=True)
            continue
        kern, plain = (model_forward(build_other(name, impl, torch.float32, state), window)
                       for impl in ("kernel", "plain"))
        tol = PRE_THRESHOLD_TOL[torch.float32]
        pairs = [("output", kern[0], plain[0])]
        if masks is not None:  # upstream of the first ROI box, then the labels
            pairs = [("bottleneck bridge", kern[2], plain[2]), ("mask_list[0]", kern[1][0],
                                                                 plain[1][0])]
        for what, got, want_t in pairs:
            err, rel = rel_err(got, want_t)
            ok = rel <= tol
            print(f"[models] {name} float32 window, kernel vs plain attention, {what}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}) "
                  f"{'ok' if ok else 'TOO FAR'}", flush=True)
            if not ok:
                fail(f"{name}: kernel and plain attention disagree in f32 at the {what}")
        if masks is not None:
            agree = (kern[0].argmax(1) == plain[0].argmax(1)).float().mean().item()
            print(f"[models] {name} float32 window: labels agree on {agree * 100:.4f}% "
                  f"(need >= {MIN_AGREEMENT * 100:.1f}%)", flush=True)
            if agree < MIN_AGREEMENT:
                fail(f"{name}: kernel and plain builds disagree end to end in f32")
        del kern, plain
        torch.cuda.empty_cache()


def mask_skip_step(attention_impl, images, labels):
    """(loss, {name: gradient}, launches) of one f32 MaskSkipTransUnet
    training step from the seed's weights: CE + DiceClass on its output (the
    JAX package's train step cannot train this model: its one-channel
    sigmoid masks do not fit the label pyramid), dropout from the phase's
    generator."""
    model = build_other("MaskSkipTransUnet", attention_impl, torch.float32).train()
    criterions = binary_losses.get_criterions(["CrossEntroLoss", "DiceClassLoss"])
    reset_launch_counts()
    with blocks.dropout_generator(dropout_generator()):
        out, _ = model(images)
    loss = sum(fn(out, labels) for fn in criterions.values())
    loss.backward()
    _sync()
    launches = launch_counts()
    grads = {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}
    return loss.item(), grads, launches, attention_layers(model)


def phase_mask_skip_train(images, labels):
    """One MaskSkipTransUnet training step on the training patch, kernel vs
    plain attention in f32: the loss and every gradient within TRAIN_TOL, the
    backward kernel launched once a layer."""
    kern = mask_skip_step("kernel", images, labels)
    plain = mask_skip_step("plain", images, labels)
    want = _per(linear_attention=kern[3], linear_attention_backward=kern[3])
    if kern[2] != want:
        fail(f"the MaskSkipTransUnet step launched {kern[2]}, not {want}")
    loss_rel, worst, median = compare_steps(
        "MaskSkipTransUnet float32 step on the training patch, kernel vs plain attention "
        f"({len(kern[1])} parameters with a gradient; backward at d = 16)",
        kern[:2], plain[:2])
    ok = (loss_rel <= TRAIN_TOL["loss"] and worst <= TRAIN_TOL["grad"]
          and median <= TRAIN_TOL["grad_median"])
    print(f"[models] MaskSkipTransUnet step: launches {kern[2]}; tol loss "
          f"{TRAIN_TOL['loss']:g}, gradients {TRAIN_TOL['grad']:g}, median "
          f"{TRAIN_TOL['grad_median']:g} {'ok' if ok else 'TOO FAR'}", flush=True)
    if not ok:
        fail("kernel and plain attention MaskSkipTransUnet steps disagree in float32")


# Phase 13: data parallelism over torch.distributed and the "attn" recompute
# policy. Two ranks share the one card over gloo, which reduces CUDA tensors
# (NCCL refuses two ranks on one device); NCCL runs at world size 1.
DP_RANKS = 2
# Under ``deterministic()`` a bf16 train step reruns bit for bit on an H100,
# so phase 13 holds each step that should equal another to the bit.
DP_WORLD_ONE_DEPTHS = (144, 80)    # 13a: run_batch's two volumes
DP_BATCH_DEPTHS = (80, 64, 48)     # 13b: three volumes, the group padded to 4
DP_DROPOUT = 0.3                   # 13b's second DP step
DP_MASK_SHAPE = (1, 32, 16, 16, 8)  # 13b: one rank's shard of activations to mask
# 13b at dropout 0.3: a weight gradient that largely cancels between the two
# samples moves with any rounding-level change by more than TRAIN_TOL (a
# 1e-7 move of the weights moves encode.block_list_3.conv2's by 1.02e-1 of
# its max, and the DP step by as much); such a gradient is held within this
# many times its own floor
FLOOR_FACTOR = 2.0


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(rank, world, port, local_rank=0):
    """The environment ``torchrun`` gives a rank (here every rank's card is
    card 0 unless ``local_rank`` says otherwise)."""
    names = {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(local_rank),
             "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def deterministic():
    """cuDNN's and PyTorch's deterministic algorithms where they have one
    (an op without one, such as the trilinear upsample's backward, warns and
    runs as always), no autotuning: what a bit-for-bit comparison of two
    runs needs."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def step_snapshot(loss, logs, model):
    """A train step's loss, logs, gradients and updated parameters, on the host."""
    return {"loss": loss.item(), "logs": {k: v.item() for k, v in logs.items()},
            "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in model.named_parameters()}}


def same_step(a, b):
    return (a["loss"] == b["loss"] and a["logs"] == b["logs"]
            and all(torch.equal(a[k][n], b[k][n]) for k in ("grads", "params")
                    for n in a[k]))


def hold_steps(tag, got, want):
    """``got`` against ``want``, two steps from the same weights, batch and
    generator under ``deterministic()``: bit for bit, or fail with their
    differences (the loss and the gradients, largest and median, as phase 8
    measures them)."""
    if not same_step(got, want):
        diff = compare_steps(tag, (got["loss"], got["grads"]), (want["loss"], want["grads"]))
        fail(f"{tag}: the steps differ by {diff}, not bit for bit")
    print(f"[dp] {tag}: bit for bit", flush=True)


def flagship_step(images, labels, criterions, dtype=torch.bfloat16, dropout=0.3, mesh=None):
    """One train step of the seed's flagship; (snapshot, launches, passes
    through Python, peak GiB)."""
    model = flagship(SEED, dtype=dtype, dropout=dropout).train()
    state = engine.create_train_state(model, learning_rate=1e-4)
    step = engine.make_train_step(model, criterions, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    passes = engine.python_passes()
    loss, logs = step(state, images, labels, DYNAMIC_WEIGHT, dropout_generator())
    torch.cuda.synchronize()
    out = (step_snapshot(loss, logs, model), launch_counts(), engine.python_passes() - passes,
           torch.cuda.max_memory_allocated() / 2 ** 30)
    del model, state
    torch.cuda.empty_cache()
    return out


def phase_dp_world_one(images, labels, criterions):
    """13a: NCCL at world size 1, a mesh made from torchrun's environment:
    the DP step equals the step without a mesh, and run_batch the runner's
    call on each volume."""
    with torchrun_env(0, 1, free_port()):
        mesh = parallel.make_mesh()
    try:
        backend = dist.get_backend()
        with deterministic():
            plain, _, _, _ = flagship_step(images, labels, criterions)
            dp, launches, passes, _ = flagship_step(images, labels, criterions, mesh=mesh)
        if passes != 2 or launches != times(PER_WINDOW["train"], passes):
            fail(f"the DP step launched {launches} in {passes} passes (a warm-up and a capture), "
                 f"not {PER_WINDOW['train']} a pass")
        hold_steps(f"13a {backend} world size {mesh.size}, DP step vs no mesh "
                   "(bf16, dropout 0.3, the step generator)", dp, plain)

        model = build_model()
        _, runner = make_eval_runner(model, EvalConfig(roi_size=512, depth_size=64,
                                                       overlap=0.6, mode="constant"))
        gen = torch.Generator(device="cpu").manual_seed(SEED + 11)
        volumes = [torch.randn(VOLUME[:4] + (d,), generator=gen).to("cuda")
                   for d in DP_WORLD_ONE_DEPTHS]
        with deterministic():
            want = [runner(v) for v in volumes]
            got = runner.run_batch(volumes, mesh=mesh)
        shapes = [tuple(o.shape) for o in got]
        if shapes != [(1, 2) + VOLUME[2:4] + (d,) for d in DP_WORLD_ONE_DEPTHS]:
            fail(f"13a run_batch gave {shapes}")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail("13a run_batch over the mesh differs from the runner's call on each volume")
        print(f"[dp] 13a {backend} world size 1: run_batch over volumes of depths "
              f"{DP_WORLD_ONE_DEPTHS} equals the runner's call on each, bit for bit", flush=True)
        del model, runner, volumes, want, got
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def dp_batch():
    """13b's global batch, phase 7's patch and a second seeded one, each with
    the label box; and the criterion schedule."""
    images, labels, criterions = train_inputs()
    gen = torch.Generator(device="cpu").manual_seed(SEED + 12)
    images = torch.cat([images, torch.randn(PATCH, generator=gen).to("cuda")])
    return images, labels.expand(DP_RANKS, *labels.shape[1:]).contiguous(), criterions


def dp_volumes():
    gen = torch.Generator(device="cpu").manual_seed(SEED + 13)
    return [torch.randn(VOLUME[:4] + (d,), generator=gen) for d in DP_BATCH_DEPTHS]


def f32_flagship(dropout=0.0):
    return flagship(SEED, dtype=torch.float32, dropout=dropout)


def joined_step(images, labels, criterions, dropout, jitter=0.0):
    """13b: one process's f32 step of the seed's flagship on the joined
    batch, dropout from the step generator, the weights moved by ``jitter``
    relative if given (the step's rounding floor); its snapshot."""
    model = f32_flagship(dropout).train()
    if jitter:
        move_weights_(model, jitter)
    state = engine.create_train_state(model, learning_rate=1e-4)
    loss, logs = engine.make_train_step(model, criterions)(
        state, images, labels, DYNAMIC_WEIGHT, dropout_generator())
    out = step_snapshot(loss, logs, model)
    del state, model
    torch.cuda.empty_cache()
    return out


def dp_masks(shard, rows):
    """13b: an element and a channel dropout mask of ``rows`` samples, drawn
    under ``shard`` (rank, size) from the step generator's seed; on the host."""
    ones = torch.ones((rows,) + DP_MASK_SHAPE[1:], device="cuda")
    with blocks.dropout_generator(dropout_generator(), shard):
        return [blocks.dropout(ones, DP_DROPOUT, True).cpu(),
                blocks.dropout(ones, DP_DROPOUT, True, channel=True).cpu()]


def dp_step(mesh, images, labels, criterions, dropout):
    """13b: one f32 DP step of the seed's flagship on this rank's shard,
    dropout from the step generator (seeded alike on every rank); (the
    step's snapshot, launches a pass through Python, seconds)."""
    model = f32_flagship(dropout).train()
    parallel.replicate(mesh, model)
    state = engine.create_train_state(model, learning_rate=1e-4)
    step = engine.make_train_step(model, criterions, mesh=mesh)
    reset_launch_counts()
    passes = engine.python_passes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, logs = step(state, parallel.shard_batch(mesh, images),
                      parallel.shard_batch(mesh, labels), DYNAMIC_WEIGHT, dropout_generator())
    torch.cuda.synchronize()
    passes = engine.python_passes() - passes
    out = (step_snapshot(loss, logs, model),
           {k: v / passes for k, v in launch_counts().items()}, time.perf_counter() - t0)
    del state, model
    torch.cuda.empty_cache()
    return out


def dp_rank(rank, world, port, workdir):
    """13b: one of two ranks on the card (gloo, the group formed here from
    torchrun's environment): the f32 DP step on this rank's patch at
    dropout 0 and at DP_DROPOUT, the rank's dropout masks, then
    batched_predictions over 13b's three volumes; writes ``rank<r>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torchrun_env(rank, world, port):
        dist.init_process_group("gloo", init_method="env://")
        mesh = parallel.make_mesh()
    try:
        images, labels, criterions = dp_batch()
        result = {"mesh": (mesh.rank, mesh.size, str(mesh.device), dist.get_backend())}
        result["step"], result["launches"], result["step_s"] = dp_step(
            mesh, images, labels, criterions, 0.0)
        result["dropout_step"], result["dropout_launches"], _ = dp_step(
            mesh, images, labels, criterions, DP_DROPOUT)
        result["masks"] = dp_masks((mesh.rank, mesh.size), 1)
        del images, labels
        # the seed's weights again, as the reference serves them
        _, runner = make_eval_runner(f32_flagship(), EvalConfig(roi_size=512, depth_size=64,
                                                                overlap=0.6, mode="constant"))
        loader = [(v.movedim(1, -1).numpy()[:, None], np.zeros(1)) for v in dp_volumes()]
        reset_launch_counts()
        with deterministic():
            result["preds"] = [(i, p.cpu()) for i, _, _, p in
                               loop.batched_predictions(loader, runner, mesh)]
        result["eval_launches"] = launch_counts()
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_dp_two_ranks():
    """13b: two gloo ranks on the card against the single-process step on
    the joined batch (f32, TF32 off; dropout 0, then DP_DROPOUT from the
    step generator), the joined batch's dropout masks and the runner's call
    on each volume."""
    images, labels, criterions = dp_batch()
    joined = {dropout: joined_step(images, labels, criterions, dropout)
              for dropout in (0.0, DP_DROPOUT)}
    moved = joined_step(images, labels, criterions, DP_DROPOUT, jitter=1e-7)
    floor = grad_errors(moved["grads"], joined[DP_DROPOUT]["grads"])
    del moved
    joined_masks = dp_masks((0, 1), DP_RANKS)
    del images, labels
    torch.cuda.empty_cache()
    _, runner = make_eval_runner(f32_flagship(), EvalConfig(roi_size=512, depth_size=64,
                                                            overlap=0.6, mode="constant"))
    with deterministic():
        want = [runner(v).cpu() for v in dp_volumes()]
    del runner
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        mp.spawn(dp_rank, args=(DP_RANKS, free_port(), workdir), nprocs=DP_RANKS, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=True)
                 for r in range(DP_RANKS)]
    for r, result in enumerate(ranks):
        if result["mesh"] != (r, DP_RANKS, "cuda:0", "gloo"):
            fail(f"13b rank {r}'s mesh is {result['mesh']}")
        for key in ("launches", "dropout_launches"):
            if result[key] != PER_WINDOW["train_f32"]:
                fail(f"13b rank {r}'s DP step launched {result[key]} a pass through Python, "
                     f"not {PER_WINDOW['train_f32']}")
        for kind, got, mask in zip(("element", "channel"), result["masks"], joined_masks):
            if not torch.equal(got, mask[r:r + 1]):
                fail(f"13b rank {r}'s {kind} dropout mask is not its row of the joined batch's")
    for key, dropout in (("step", 0.0), ("dropout_step", DP_DROPOUT)):
        steps = [result[key] for result in ranks]
        if not all(torch.equal(steps[0]["params"][n], steps[1]["params"][n])
                   for n in steps[0]["params"]):
            fail(f"13b: the ranks' parameters differ after the step at dropout {dropout}")
        if steps[0]["loss"] != steps[1]["loss"]:
            fail(f"13b: the ranks report different losses {steps[0]['loss']}, {steps[1]['loss']}")
        loss_rel, worst, median = compare_steps(
            f"13b {DP_RANKS} gloo ranks on one card, the f32 DP step at dropout {dropout:g} vs "
            f"one process on the joined batch of {DP_RANKS}",
            (steps[0]["loss"], steps[0]["grads"]),
            (joined[dropout]["loss"], joined[dropout]["grads"]))
        if dropout:
            # a gradient whose own rounding floor passes TRAIN_TOL is held
            # within FLOOR_FACTOR times that floor
            errors = grad_errors(steps[0]["grads"], joined[dropout]["grads"])
            over = {n: (e, floor[n]) for n, e in errors.items()
                    if e > max(TRAIN_TOL["grad"], FLOOR_FACTOR * floor[n])}
            grads_ok = not over
            worst_floor = max(floor.items(), key=lambda kv: kv[1])
            rule = (f"each within max({TRAIN_TOL['grad']:g}, {FLOOR_FACTOR:g} x its floor; the "
                    f"largest floor {worst_floor[1]:.3e} at {worst_floor[0]}){'' if grads_ok else f' NOT: {over}'}")
        else:
            grads_ok, rule = worst <= TRAIN_TOL["grad"], f"{TRAIN_TOL['grad']:g}"
        ok = loss_rel <= TRAIN_TOL["loss"] and grads_ok and median <= TRAIN_TOL["grad_median"]
        print(f"[dp] 13b at dropout {dropout:g}: tol loss {TRAIN_TOL['loss']:g}, gradients "
              f"{rule}, median {TRAIN_TOL['grad_median']:g} {'ok' if ok else 'TOO FAR'}; the "
              f"ranks' parameters bit-equal after the step", flush=True)
        if not ok:
            fail(f"13b: the DP step at dropout {dropout:g} and the joined batch's step disagree")
    if joined[0.0]["loss"] == joined[DP_DROPOUT]["loss"]:
        fail("13b: dropout did not change the joined batch's loss")
    print(f"[dp] 13b: each rank's element and channel dropout masks are its rows of the "
          f"joined batch's, bit for bit; per rank {ranks[0]['launches']['linear_attention']:g} "
          f"forward and {ranks[0]['launches']['linear_attention_backward']:g} backward attention "
          f"launches a pass through Python; the first DP step took "
          f"{[round(x['step_s'] * 1e3, 2) for x in ranks]} ms (first step of each process: its "
          f"warm-up, capture and replay, gloo's host copies of the gradients included)",
          flush=True)

    for r, result in enumerate(ranks):
        preds = result["preds"]
        if [i for i, _ in preds] != list(range(len(DP_BATCH_DEPTHS))):
            fail(f"13b rank {r} yielded volumes {[i for i, _ in preds]}")
        if not all(torch.equal(p, w) for (_, p), w in zip(preds, want)):
            diffs = [((p - w).abs().max().item(), (p != w).float().mean().item())
                     for (_, p), w in zip(preds, want)]
            fail(f"13b rank {r}: run_batch's outputs differ from the runner's call on each "
                 f"volume (largest difference and share of values that differ, a volume: "
                 f"{diffs})")
    windows = [_windows(VOLUME[2:4] + (d,), (512, 512, 64), 0.6) for d in DP_BATCH_DEPTHS]
    eval_launches = [x["eval_launches"]["linear_attention"] for x in ranks]
    # groups of 2: (0, 1), then (2, and 2 again as the pad): rank 0 serves
    # volumes 0 and 2, rank 1 volume 1 and the pad
    want_launches = [32 * (windows[0] + windows[2]), 32 * (windows[1] + windows[2])]
    if eval_launches != want_launches:
        fail(f"13b run_batch launched {eval_launches} forward attention kernels, not {want_launches}")
    print(f"[dp] 13b: batched_predictions over {len(DP_BATCH_DEPTHS)} volumes of depths "
          f"{DP_BATCH_DEPTHS} (the group padded to 4) equals the runner's call on each, bit for "
          f"bit, on both ranks; forward launches per rank {eval_launches}; the two ranks' "
          f"processes took {spawn_s:.1f} s", flush=True)


def phase_remat(images, labels, criterions):
    """13c: REMAT "attn" on phase 7's bf16 step (dropout 0.3, the step
    generator): the recompute's launches, its loss and gradients against the
    step without it, and both peaks."""
    with deterministic():
        plain, plain_launches, _, plain_peak = flagship_step(images, labels, criterions)
        blocks.REMAT = "attn"
        try:
            remat, launches, passes, peak = flagship_step(images, labels, criterions)
        finally:
            blocks.REMAT = ""
    want = times(_per(linear_attention=64, linear_attention_backward=32, conv_wgrad=3,
                      conv_narrow=5, conv_depthwise=PEG_CALLS), passes)
    if passes != 2 or launches != want:
        fail(f"the recompute step launched {launches} in {passes} passes, not {want} in 2 (a "
             f"warm-up and a capture)")
    hold_steps("13c REMAT attn vs none (bf16, dropout 0.3, the step generator)", remat, plain)
    print(f"[dp] 13c: launches {launches['linear_attention']} forward and "
          f"{launches['linear_attention_backward']} backward attention kernels (without "
          f"recompute {plain_launches['linear_attention']} and "
          f"{plain_launches['linear_attention_backward']}), each over the step's warm-up and "
          f"capture; peak memory {peak:.2f} GiB with "
          f"recompute, {plain_peak:.2f} GiB without", flush=True)


def cli_rank(rank, world, port, root, data_dir, split):
    """13d: one torchrun-style rank of ``train3d`` on phase 10's workspace
    (the gloo group formed here, before the CLI joins it); writes
    ``cli<r>.pt``."""
    with torchrun_env(rank, world, port):
        dist.init_process_group("gloo", init_method="env://")
        try:
            argv = ["--dir_data", data_dir, "--split_json", split, "--fold_num", "0",
                    "--log_dir", os.path.join(root, "runs"),
                    "--model_dir", os.path.join(root, "out"), *CLI_TRAIN_FLAGS]
            with command_line(argv):
                args = train3d.get_parse()
            epoch_s, waits = [], []
            with timed(loop, "train_on_epoch", epoch_s), train_waits(waits):
                reset_launch_counts()
                before = python_passes()
                state = train3d.main(args)
                _sync()
            passes, replays = (b - a for a, b in zip(before, python_passes()))
            result = {"launches": launch_counts(), "epoch_s": epoch_s, "waits": waits,
                      "passes": passes, "replays": replays,
                      "step": state.step,
                      "params": {n: p.detach().cpu() for n, p in state.model.named_parameters()},
                      "finite": bool(grads_finite(state.model))}
            torch.save(result, os.path.join(root, f"cli{rank}.pt"))
        finally:
            dist.destroy_process_group()


def phase_dp_cli(train_ms, cli_ms):
    """13d: ``train3d`` on two torchrun-style gloo ranks on the card, one
    epoch with its eval, over phase 10's workspace."""
    with tempfile.TemporaryDirectory() as root:
        data_dir, split = cli_workspace(root, CLI_SHAPE, CLI_PATIENTS)
        train_ids, test_ids = data.load_fold(split, 0)
        t0 = time.perf_counter()
        mp.spawn(cli_rank, args=(DP_RANKS, free_port(), root, data_dir, split),
                 nprocs=DP_RANKS, join=True)
        total_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(root, f"cli{r}.pt"), weights_only=True)
                 for r in range(DP_RANKS)]
        runs = {d: os.listdir(os.path.join(root, d)) for d in ("out", "runs")}
        if len(runs["out"]) != 1 or runs["runs"] != runs["out"]:
            fail(f"13d: the ranks wrote run directories {runs}, not rank 0's one")
        run = os.path.join(root, "out", runs["out"][0], "fold_0")
        artifacts = sorted(os.listdir(run))
        logs = [os.path.join(d, f) for d, _, files in os.walk(os.path.join(root, "runs"))
                for f in files if f == "metrics.jsonl"]
        records = [json.loads(line) for line in open(logs[0])] if len(logs) == 1 else []
    if len(logs) != 1:
        fail(f"13d: {len(logs)} metrics.jsonl written, not rank 0's one")
    if not {"temp_model", "train_state", "model"} <= set(artifacts):
        fail(f"13d: rank 0 wrote {artifacts}")
    tags = {r["tag"] for r in records}
    if not {"train/total_loss", "eval/DiceClassLoss"} <= tags or not all(
            math.isfinite(r["value"]) for r in records):
        fail(f"13d: metrics.jsonl {records}")
    num_samples = int(CLI_TRAIN_FLAGS[CLI_TRAIN_FLAGS.index("--num_samples") + 1])
    steps = -(-len(train_ids) // DP_RANKS) * num_samples
    # the eval: the 2 test volumes one a rank, each on its own window grid
    per_volume = _windows(CLI_SHAPE[1:] + CLI_SHAPE[:1], (512, 512, 64), EvalConfig().overlap)
    for r, result in enumerate(ranks):
        if result["step"] != steps or result["replays"] != steps or not result["finite"]:
            fail(f"13d rank {r}: {result['step']} steps, {result['replays']} replayed (want "
                 f"{steps}), finite {result['finite']}")
        want = train_launches(result["passes"], per_volume)
        if result["launches"] != want:
            fail(f"13d rank {r} launched {result['launches']}, not {want} ({result['passes']} "
                 f"passes through Python)")
    if not all(torch.equal(ranks[0]["params"][n], ranks[1]["params"][n]) for n in ranks[0]["params"]):
        fail("13d: the ranks' parameters differ at the end")
    ms = [sum(x["epoch_s"]) / steps * 1e3 for x in ranks]
    waits = [sum(x["waits"]) for x in ranks]
    busy_ms = [(sum(x["epoch_s"]) - w) / steps * 1e3 for x, w in zip(ranks, waits)]
    losses = [round(r["value"], 6) for r in records if r["tag"] == "train/total_loss"]
    print(f"[dp] 13d: train3d on {DP_RANKS} torchrun-style gloo ranks on one card "
          f"({len(train_ids)} train patients, one a rank, {num_samples} steps each of a global "
          f"batch of {DP_RANKS}; {len(test_ids)} eval volumes, one a rank): launches per rank "
          f"{ranks[0]['launches']}; only rank 0 wrote ({artifacts}, one metrics.jsonl, patient "
          f"losses {losses}); the ranks' parameters bit-equal at the end; "
          f"{[round(x, 2) for x in ms]} ms per step through the CLI with the data waits "
          f"(each rank waited {[round(w, 3) for w in waits]} s for its patient), "
          f"{[round(x, 2) for x in busy_ms]} without, against phase 10's {cli_ms:.2f} with "
          f"its waits and phase 7's {train_ms:.2f}; {total_s:.1f} s with the processes' start",
          flush=True)


# Phase 14: the floors of the window, the fused window and the step, and
# the 40-step trajectory kernel vs plain. JAX against the torch reference
# drifted to 2.79e-3 over the same 40 steps, and the port against JAX (both
# on the CPU, tools/parity_training.py) to 9.0e-3, each the steps where a
# ROI box moved by a pixel (the loss after them within 1e-4 again).
FLOOR_PROGRAMS = ("window", "fused", "step")
TRAJECTORY_STEPS = 40
TRAJECTORY_LR = 3e-5
TRAJECTORY_TOL = 2e-2


def phase_floors():
    """14a and 14b: the counts on the host, then each program on the card."""
    t0 = time.perf_counter()
    costs = {(program, 1): roofline.count(program) for program in FLOOR_PROGRAMS}
    count_s = time.perf_counter() - t0
    for (program, _), cost in costs.items():
        if min(cost.flops, cost.bytes_fused, cost.bytes_eager) <= 0:
            fail(f"14a: the {program} count is not positive: {cost}")
        print(f"[floor] 14a {roofline.count_line(program, cost)}", flush=True)
    if costs["fused", 1].flops != costs["window", 1].flops:
        fail(f"14a: the fused window counts {costs['fused', 1].flops} FLOPs, the default "
             f"{costs['window', 1].flops}")
    print(f"[floor] 14a: the fused window's FLOPs equal the default's; counted in "
          f"{count_s:.1f} s on the host", flush=True)
    card_name = card()
    for program in FLOOR_PROGRAMS:
        times = roofline.timed(program)
        print("[floor] 14b " + roofline.timing_line(
            program, roofline.function_cost(program, 1, costs), times, card_name), flush=True)


def phase_trajectory():
    """14c: 40 binary SMALL steps, the kernels against the plain path."""
    t0 = time.perf_counter()
    with deterministic():
        kernel, plain = parity_training.kernel_vs_plain(
            "binary", TRAJECTORY_LR, TRAJECTORY_STEPS, "cuda")
    rel = parity_training.max_rel_diff(plain.losses, kernel.losses)
    finite = all(math.isfinite(x) for x in kernel.losses + plain.losses)
    worst = max(range(TRAJECTORY_STEPS), key=lambda t: abs(kernel.losses[t] - plain.losses[t]))
    print(f"[trajectory] 14c: {TRAJECTORY_STEPS} binary SMALL steps at lr {TRAJECTORY_LR:g} "
          f"(f32, TF32 off, deterministic), kernel vs plain: largest relative loss difference "
          f"{rel:.3e} at step {worst} (tol {TRAJECTORY_TOL:g}); losses kernel "
          f"{kernel.losses[0]:.6f} -> {kernel.losses[-1]:.6f}, plain {plain.losses[0]:.6f} -> "
          f"{plain.losses[-1]:.6f}; {time.perf_counter() - t0:.1f} s", flush=True)
    if not finite:
        fail(f"14c: non-finite losses (kernel from step {kernel.first_nonfinite}, "
             f"{kernel.module}; plain from step {plain.first_nonfinite}, {plain.module})")
    if not rel <= TRAJECTORY_TOL:
        fail(f"14c: the kernels' trajectory is {rel:.3e} from the plain one")


# Phase 15: the user-facing entry points, each started as a user starts it:
# (label, bench arguments, environment, the launches held per window or step)
BENCH_CALLS = (
    ("default", [], {}, PER_WINDOW["default"]),
    ("fused", [], {"LINTRANSUNET_FUSED_S1": "1", "LINTRANSUNET_FUSED_STACK": "1"},
     PER_WINDOW["fused"]),
    ("train", ["--train"], {}, PER_WINDOW["train"]),
)
BENCH_TIMEOUT = 600
REPO = os.path.dirname(os.path.abspath(__file__))


def phase_bench():
    """15a: ``python3 -m lintransunet_tpu_torch.bench``, then with the fused
    configuration's two variables, then ``--train``, each in a subprocess:
    rc 0, one JSON line with a finite positive value, 5 windows a volume,
    and each kernel's launches per window (or step) as phases 3, 5 and 7
    hold them. Returns {label: the JSON line}."""
    card_name = card()
    results = {}
    for label, args, env, per in BENCH_CALLS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "lintransunet_tpu_torch.bench", *args],
                              capture_output=True, text=True, timeout=BENCH_TIMEOUT, cwd=REPO,
                              env=dict(os.environ, **env))
        took = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"15a: the {label} bench exited {proc.returncode}: {proc.stderr[-2000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        if not (math.isfinite(result["value"]) and result["value"] > 0):
            fail(f"15a: the {label} bench's value {result['value']}")
        found = re.search(r"launches per (?:window|step) (\{.*\})", proc.stderr)
        launches = json.loads(found.group(1)) if found else {}
        if launches != {name: float(per[name]) for name in launches} or not launches:
            fail(f"15a: the {label} bench launched {launches} per window or step, not {per}")
        if label != "train" and f"windows={WINDOWS_PER_VOLUME} " not in proc.stderr:
            fail(f"15a: the {label} bench did not serve {WINDOWS_PER_VOLUME} windows a volume: "
                 f"{proc.stderr[-500:]}")
        diagnostics = " | ".join(line for line in proc.stderr.splitlines()
                                 if line.startswith(("windows=", "loss=")))
        print(f"[bench] 15a {label}: {json.dumps(result)} ({card_name}); {diagnostics}; "
              f"launches {launches}; {took:.1f} s with the process's start", flush=True)
        results[label] = result
    return results


def phase_entry():
    """15b: ``entry()`` on the card: the flagship's bf16 one-hot eval
    forward on the zero 96^3 patch, (1, 2, 96, 96, 96), finite, one class a
    voxel, 32 attention launches."""
    fn, (model, x) = entry_points.entry()
    reset_launch_counts()
    out = fn(model, x)
    torch.cuda.synchronize()
    launches = launch_counts()
    if tuple(out.shape) != (1, 2, 96, 96, 96) or out.dtype != torch.bfloat16:
        fail(f"15b: entry's output {out.dtype} {tuple(out.shape)}")
    if not torch.isfinite(out).all() or not torch.equal(out.float().sum(dim=1),
                                                        torch.ones_like(out[:, 0]).float()):
        fail("15b: entry's output is not a finite one-hot")
    if launches != PER_WINDOW["default"]:
        fail(f"15b: entry's forward launched {launches}, not {PER_WINDOW['default']}")
    print(f"[entry] 15b: entry forward: {tuple(out.shape)} {out.dtype}, finite one-hot, "
          f"foreground share {out[:, 1].float().mean().item():.4f}; launches {launches}",
          flush=True)
    del model, x, out
    torch.cuda.empty_cache()


def phase_dryrun():
    """15c: ``dryrun_multichip(2)``: two gloo ranks sharing the card, bf16,
    every check of the dry run held in the ranks."""
    t0 = time.perf_counter()
    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        entry_points.dryrun_multichip(DP_RANKS)
    lines = [line for line in report.getvalue().splitlines() if line.startswith("dryrun")]
    if len(lines) != 4:
        fail(f"15c: the dry run printed {lines}")
    for line in lines:
        print(f"[entry] 15c: {line}", flush=True)
    print(f"[entry] 15c: dryrun_multichip({DP_RANKS}) on gloo ranks sharing the card passed in "
          f"{time.perf_counter() - t0:.1f} s with the processes' start", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on an NVIDIA GPU")
    # f32 comparisons are f32 throughout; the bf16 model is unaffected
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    phase_kernels()

    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    volumes = [torch.randn(VOLUME, generator=gen).to("cuda") for _ in range(N_VOLUMES)]
    window = volumes[0][..., :64].contiguous()
    default = build_model()
    phase_slice(default, volumes, "default")
    phase_end_to_end(default, window)
    phase_fused_qkv(default, window)
    fused_model = build_model(fused_config=True)
    phase_slice(fused_model, volumes, "fused")
    phase_fused_vs_default(default, fused_model, window)
    del default, fused_model, volumes
    torch.cuda.empty_cache()

    images, labels, criterions = train_inputs()
    train_ms = phase_train(images, labels, criterions)
    phase_train_vs_plain(images, labels, criterions)
    del images, labels
    torch.cuda.empty_cache()
    cli_ms = phase_cli(train_ms)
    phase_multi_class_cli(train_ms)
    torch.cuda.empty_cache()
    window = torch.randn(WINDOW, generator=torch.Generator().manual_seed(SEED + 10)).to("cuda")
    phase_other_models(window)
    del window
    torch.cuda.empty_cache()
    images, labels, _ = train_inputs()
    phase_mask_skip_train(images, labels)
    del images, labels
    torch.cuda.empty_cache()
    images, labels, criterions = train_inputs()
    phase_dp_world_one(images, labels, criterions)
    phase_remat(images, labels, criterions)
    del images, labels
    torch.cuda.empty_cache()
    phase_dp_two_ranks()
    phase_dp_cli(train_ms, cli_ms)
    t0 = time.perf_counter()
    phase_floors()
    torch.cuda.empty_cache()
    phase_trajectory()
    print(f"[floor] phase 14 took {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_bench()
    phase_entry()
    phase_dryrun()
    print(f"[entry] phase 15 took {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
