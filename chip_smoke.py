"""Drive the PyTorch port's serving and training paths once on one NVIDIA GPU.

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
2. kernel vs plain, each kernel against its plain PyTorch version at the
   shapes the main paths give it, in f32 (TF32 off) and bf16, timed with
   CUDA events in turns plain, kernel, kernel, plain, beside its bound (the
   least time the card could take: the larger of the compulsory bytes at
   3.35 TB/s and the operations at 989 TFLOP/s in bf16, 67 TFLOP/s in f32):
   a. linear attention at the four attention shapes of a window in the
      model's layout (the head-split view of a (1, N, BH*d) projection;
      these calls make the kernels line), then contiguous at the same shapes
      plus a ragged and a one-token case; each case also prints one call's
      CUDA launches (the host's ``cudaLaunch*`` calls under
      ``torch.profiler``, ``kernels.launches``) and fails above two;
   b. the conv unit at the seven units of a window of the fused
      configuration, with ``F.conv3d`` alone (cuDNN) on the same input and
      weights timed as a yardstick: bf16 as the model runs it, f32 with
      ``compute_dtype=float32``, and f32 activations with the default bf16
      operands (what an f32 fused model runs);
   c. the transformer stack at the four token stacks of a window, one and
      seven layers, with its executed TFLOP/s and share of its bound (no
      single PyTorch call computes a stack);
   d. the linear-attention backward likewise at the four attention shapes
      of the training patch, in the model's layout and then contiguous, plus
      a ragged and a one-token case, with one call's CUDA launches (no
      single PyTorch call computes it);
   e. the six conv probes (``lintransunet_tpu_torch/experiments``, the H100
      counterparts of the TPU probes under ``experiments/``) at their TPU
      probes' main shapes in bf16 (``conv3d_cl_rows`` also in f32), beside
      the library call that computes the same function where there is one
      (``einsum``; for the row-offset probe's B and C ``F.conv1d`` with
      dilation on the taps folded per offset, the fold inside the call;
      ``F.conv3d`` in ``channels_last_3d``; ``torch.var_mean``), plain,
      kernel and library call timed alike (warmed, then 10-call windows in
      turns plain, kernel, library, library, kernel, plain), each with the
      kernel's and the library call's TFLOP/s and the kernel's share of its
      bound; the inner-loop probe's three strategies beside ``F.conv3d`` on
      the same tensor, a yardstick that computes the same function but at
      the wrap columns (not the kernels line's library call); the tap sums
      and the inner-loop probe also print their card time (the calls queued
      behind a sleep) beside their events;
3. the default path at full width: the flagship ``MaskTransUnet`` (random
   weights from a seed, f32 parameters, bf16 compute) behind
   ``make_eval_runner`` answers three 512 x 512 x 144 volumes (5 windows
   each); the attention kernel must launch 32 times a window and the other
   two kernels never;
4. kernel vs plain attention end to end on one window of the default path:
   in bf16 and f32 the ConnectBridge output and the coarsest mask (both
   upstream of the first ROI box threshold) within PRE_THRESHOLD_TOL; the
   f32 foreground labels agree on at least 99.9% of voxels;
5. the fused configuration at full width: the same weights with
   ``fused_s1=True, fused_stack=True`` answer the same three volumes; per
   window exactly 7 conv-unit and 8 stack launches, and no standalone
   attention launch;
6. fused vs default end to end on one window, same weights: the
   ConnectBridge output and the coarsest mask within FUSED_TOL in bf16 and
   f32, and both configurations' window forward times. The fused conv unit
   rounds its operands to bf16 in an f32 model too (as the JAX package's),
   so the f32 labels are printed, not held, here; phase 4 holds them;
7. the binary training step at full width: the flagship (bf16 compute, f32
   parameters, dropout 0.3) on one 512 x 512 x 32 patch, the 5-level
   deep-supervision criterion schedule with the epoch-0 weights, AdamW at
   lr 1e-4; one warm step, then TRAIN_STEPS timed steps with one
   synchronise at the end. Every step's loss and gradients are finite and
   it launches exactly 32 forward and 32 backward attention kernels and
   none of the others; prints ms per step and the peak memory;
8. kernel vs plain attention on one train step, same weights, batch and
   dropout generator: in f32 (TF32 off) the loss and every parameter's
   gradient within TRAIN_TOL, beside the floor that a rounding-level change
   gives (the kernel build with its weights moved by 1e-7 relative); in bf16
   the step's differences are printed, and the ConnectBridge gradients of
   the coarsest deep-supervision term alone (upstream of the first ROI box)
   are held within UPSTREAM_GRAD_TOL;
9. the probes' path: each probe's entry point called once at its main
   shape, through the wrapper a user of ``python -m
   lintransunet_tpu_torch.experiments.<probe>`` calls; each launches its
   kernel exactly once and gives finite output of the expected shape.

The last two lines are a JSON summary of the kernels (bf16; the forward
kernels' per-window sums over their serving calls, the backward's per-step
sum over its training calls, each probe's one call at its main shape) and
``{"ok": true, "device": {...}}``.
Imports nothing of jax.
"""

import ctypes
import json
import re
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch import engine, kernels
from lintransunet_tpu_torch.cli.common import EvalConfig, get_criterion_list, make_eval_runner
from lintransunet_tpu_torch.engine import make_eval_forward
from lintransunet_tpu_torch.experiments import (
    conv_prototype,
    conv_retired,
    dot_probe,
    in_stats_probe,
    inner_probe,
    rowoffset_probe,
)
from lintransunet_tpu_torch.experiments.common import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    bound,
    card_line,
    cuda_ms,
    in_turns,
)
from lintransunet_tpu_torch.kernels.launches import cuda_launches
from lintransunet_tpu_torch.models import MaskTransUnet, init_random_
from lintransunet_tpu_torch.ops import conv_unit as cu
from lintransunet_tpu_torch.ops import fused_stack as fs
from lintransunet_tpu_torch.ops import linear_attention as fused

SEED = 0
FLAGSHIP = dict(num_layers=(16, 32, 64, 128, 256),
                roi_size_list=(100, 65, 40, 25, 10),
                is_roi_list=(False, True, True, True, True),
                dim_input=1, dim_output=2, n_layers=8)
VOLUME = (1, 1, 512, 512, 144)
N_VOLUMES = 3
WINDOWS_PER_VOLUME = 5      # depth 144, roi depth 64, overlap 0.6
KERNEL_NAMES = ("linear_attention", "conv_unit", "fused_stack", "probe_taps",
                "probe_conv", "probe_stats")
# The probes' tensor-core kernels whose registers and spills phase 1 prints
# on a line each: (library, kernel)
PROBE_MMA_KERNELS = (("probe_conv", "conv_mma"), ("probe_taps", "taps_fold"),
                     ("probe_taps", "taps_fold_weights"), ("probe_taps", "inner_taps"))
# The probes: name -> (kernel source, the TPU kernel's pallas_call it replaces)
PROBES = {"tap_sum": ("probe_taps", "experiments/pallas_dot_probe.py:41"),
          "row_offset_sum": ("probe_taps", "experiments/pallas_rowoffset_probe.py:53"),
          "inner_step": ("probe_taps", "experiments/pallas_inner_probe.py:226"),
          "conv3d_cl": ("probe_conv", "experiments/pallas_conv_prototype.py:90"),
          "conv3d_cl_rows": ("probe_conv", "experiments/pallas_conv_retired.py:149"),
          "lane_sums": ("probe_stats", "experiments/in_stats_probe.py:90")}


def _per(**counts):
    names = ("linear_attention", "linear_attention_backward", "conv_unit",
             "fused_stack") + tuple(PROBES)
    return {name: counts.get(name, 0) for name in names}


# launches per window (serving), step (training) or run (probes) of each
# kernel wrapper
PER_WINDOW = {"default": _per(linear_attention=32),
              "fused": _per(conv_unit=7, fused_stack=8),
              "train": _per(linear_attention=32, linear_attention_backward=32),
              "probes": _per(**{name: 1 for name in PROBES})}
# (BH, N, d) of the window's attention calls: bottleneck, levels 3, 2, 1
MAIN_SHAPES = [(8, 4096, 32), (8, 2160, 32), (8, 5376, 32), (4, 28704, 32)]
# the same on the 512 x 512 x 32 training patch (half the window's depth)
TRAIN_SHAPES = [(8, 2048, 32), (8, 1080, 32), (8, 2688, 32), (4, 14352, 32)]
PATCH = (1, 1, 512, 512, 32)
LABEL_BOX = (slice(200, 320), slice(220, 300), slice(8, 24))  # bench.py:189-190
TRAIN_STEPS = 5
# epoch-0 deep-supervision weights (bench.py:199-203)
DYNAMIC_WEIGHT = engine.get_dynamic_weight(
    epochs=1, T=12.0, warmup_step=10, weight_list=(0.05, 0.05, 0.1, 0.1, 1.0),
    initial_weight=(0.1, 0.2, 0.3, 0.4, 1.0), final_weight=(2.0, 1.5, 1.0, 1.0, 1.0))[0]
EXTRA_SHAPES = [(8, 300, 32), (8, 1, 32)]
MAX_LAUNCHES = 2  # CUDA launches of one attention call, forward or backward
# The window's seven conv units in the fused configuration:
# (name, Ca, Cb, O, (H, W, D), prologue affine on xa)
CONV_SHAPES = [
    ("encoder input block", 4, 0, 16, (256, 256, 64), False),
    ("encoder block 0 conv1", 16, 0, 16, (256, 256, 64), False),
    ("encoder block 1 conv1", 32, 0, 32, (128, 128, 64), False),
    ("decoder level 1 conv1", 64, 0, 32, (128, 128, 64), False),
    ("decoder level 1 conv2", 32, 32, 32, (128, 128, 64), True),
    ("decoder level 0 conv1", 32, 0, 16, (256, 256, 64), False),
    ("decoder level 0 conv2", 16, 16, 16, (256, 256, 64), True),
]
# The window's four token stacks (N, C); each runs as 1 + 7 layers
STACK_SHAPES = [(4096, 256), (2160, 256), (5376, 256), (28704, 128)]
# max |kernel - plain| <= TOL * max |plain|. f32: the same f32 math summed
# in another order. bf16: each side rounds its f32 result to bf16 once, at
# places that can differ by a bf16 ulp (2^-8 relative); conv statistics are
# sums of outputs that can sit one ulp apart; the stack's kernel rounds
# every product's operands to bf16 (as the TPU kernel), its plain version
# computes in f32 (measured on an H100: 1.0e-2 at seven layers).
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
CONV_STATS_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
STACK_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
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
ITERS = 10


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want):
    """(max |got - want|, that over max |want|) in f32."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err, (err / scale if scale else err)


def pkkp(plain, kern, iters=ITERS):
    """(kernel ms, plain ms): warm, then plain, kernel, kernel, plain."""
    for fn in (kern, plain):
        cuda_ms(fn, 2, warmup=0)
    p1, k1, k2, p2 = (cuda_ms(fn, iters, warmup=0) for fn in (plain, kern, kern, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


class Summary:
    """Per-window sums of one kernel's main-path calls in bf16."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = self.t_ops = self.t_bytes = 0.0
        self.library_ms = None
        self.max_abs_err = 0.0

    def add(self, dtype, calls, ms, plain_ms, flops, nbytes, library_ms=None):
        if dtype != torch.bfloat16:
            return
        self.ms += calls * ms
        self.plain_ms += calls * plain_ms
        self.bound_ms += calls * bound(flops, nbytes, dtype)[0]
        self.t_ops += calls * flops / PEAK_FLOPS[dtype]
        self.t_bytes += calls * nbytes / HBM_BYTES_PER_S
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + calls * library_ms

    def entry(self, launches):
        return {"launches": launches, "max_abs_err": self.max_abs_err,
                "ms": self.ms, "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "operations" if self.t_ops >= self.t_bytes else "bytes",
                "library_ms": self.library_ms}


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


def attention_inputs(count, bh, n, d, layout, dtype, gen):
    """``count`` (1, BH, N, d) tensors on the card: contiguous, or (``heads``)
    the head-split view of a contiguous (1, N, BH*d) projection, the layout
    the model passes."""
    if layout == "heads":
        return [torch.randn((1, n, bh * d), generator=gen).to("cuda", dtype)
                .view(1, n, bh, d).transpose(1, 2) for _ in range(count)]
    return [torch.randn((1, bh, n, d), generator=gen).to("cuda", dtype) for _ in range(count)]


def attention_cases(shapes):
    """(shape, layout) of phases 2a and 2d: the main shapes in the model's
    layout, then contiguous at the main shapes and the ragged and one-token
    cases."""
    return ([(shape, "heads") for shape in shapes]
            + [(shape, "contiguous") for shape in shapes + EXTRA_SHAPES])


def check_launches(tag, label, found, calls=3):
    """Print one call's CUDA launches (of ``calls`` profiled) and the device
    rows kept; fail unless there are one or two launches a call and no more
    rows than launches."""
    launches, _, rows = found
    per_call, rows_per_call = len(launches) / calls, len(rows) / calls
    short = sorted({name.replace("(anonymous namespace)::", "").replace("void ", "", 1)
                    .split("(")[0].strip() for name in rows})
    print(f"[{tag}] {label}: CUDA launches per call {per_call:g} (device rows kept "
          f"{rows_per_call:g}: {short})", flush=True)
    if not 1 <= per_call <= MAX_LAUNCHES or rows_per_call > per_call:
        fail(f"{tag} {label}: a call launched {per_call:g} CUDA kernels ({rows_per_call:g} "
             f"device rows), not 1 to {MAX_LAUNCHES}")


def phase_attention_vs_plain():
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    summary = Summary()
    for dtype in (torch.float32, torch.bfloat16):
        for (bh, n, d), layout in attention_cases(MAIN_SHAPES):
            q, k, v = attention_inputs(3, bh, n, d, layout, dtype, gen)
            got = fused.linear_attention(q, k, v)
            want = fused.linear_attention_reference(q, k, v)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != want.shape:
                fail(f"kernel output {got.dtype} {tuple(got.shape)}")
            err, rel = rel_err(got, want)
            summary.max_abs_err = max(summary.max_abs_err, err)
            ms, plain_ms = pkkp(lambda: fused.linear_attention_reference(q, k, v),
                                lambda: fused.linear_attention(q, k, v), 20)
            nbytes = 4 * bh * n * d * q.element_size()
            flops = 4 * bh * n * d * d
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            if layout == "heads":
                summary.add(dtype, 8, ms, plain_ms, flops, nbytes)
            ok = rel <= TOL[dtype]
            label = f"{str(dtype)[6:]:8s} {layout:10s} BH={bh} N={n} d={d}"
            print(f"[attention] {label}: max_abs_err {err:.3e} rel {rel:.3e} (tol "
                  f"{TOL[dtype]:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'TOO FAR'}",
                  flush=True)
            if not ok:
                fail(f"kernel disagrees with plain at {dtype} {layout} {(bh, n, d)}")
            check_launches("attention", label,
                           cuda_launches(lambda: fused.linear_attention(q, k, v), 3))
    print(f"[attention] one window's 32 bf16 calls (the model's layout): kernel "
          f"{summary.ms:.4f} ms, plain {summary.plain_ms:.4f} ms, bound "
          f"{summary.bound_ms:.4f} ms; no single PyTorch call computes linear attention "
          f"(scaled_dot_product_attention is softmax attention)", flush=True)
    return summary


def phase_conv_vs_plain():
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    summary = Summary()
    # (activation dtype, operand dtype): f32 throughout, the bf16 main path,
    # and f32 activations with the default bf16 operands
    for dtype, compute in ((torch.float32, torch.float32),
                           (torch.bfloat16, torch.bfloat16),
                           (torch.float32, torch.bfloat16)):
        for name, ca, cb, o, spatial, affine in CONV_SHAPES:
            rnd = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
            w = (rnd(o, ca + cb, 3, 3, 3) / (27 * (ca + cb)) ** 0.5).to("cuda")
            xa = rnd(1, ca, *spatial).to("cuda", dtype)
            kw = dict(bias=(rnd(o) * 0.1).to("cuda"), compute_dtype=compute)
            if cb:
                kw.update(xb=rnd(1, cb, *spatial).to("cuda", dtype), wb=w[:, ca:])
            if affine:
                kw["affine_a"] = torch.stack([rnd(1, ca).abs() + 0.5, rnd(1, ca)],
                                             dim=1).to("cuda")
            wa = w[:, :ca]
            got = cu.conv_unit(xa, wa, **kw)
            want = cu.conv_unit_reference(xa, wa, **kw)
            torch.cuda.synchronize()
            if got[0].dtype != dtype or got[0].shape != want[0].shape:
                fail(f"conv unit output {got[0].dtype} {tuple(got[0].shape)}")
            err, rel = rel_err(got[0], want[0])
            serr, srel = rel_err(got[1], want[1])
            summary.max_abs_err = max(summary.max_abs_err, err)
            ms, plain_ms = pkkp(lambda: cu.conv_unit_reference(xa, wa, **kw),
                                lambda: cu.conv_unit(xa, wa, **kw))
            x_cat = torch.cat([xa, kw["xb"]], dim=1) if cb else xa
            w_dt, b_dt = w.to(dtype), kw["bias"].to(dtype)
            # warmed first: cuDNN picks its algorithm on the first call
            library_ms = cuda_ms(lambda: F.conv3d(x_cat, w_dt, b_dt, 1, 1), ITERS, 2)
            voxels = spatial[0] * spatial[1] * spatial[2]
            flops = 2 * voxels * o * 27 * (ca + cb)
            nbytes = (xa.element_size() * voxels * (ca + cb + o)
                      + 4 * (w.numel() + o + 2 * o + (2 * ca if affine else 0)))
            bound_ms, bound_by = bound(flops, nbytes, compute)
            if dtype == compute:
                summary.add(dtype, 1, ms, plain_ms, flops, nbytes, library_ms)
            ok = rel <= TOL[dtype] and srel <= CONV_STATS_TOL[dtype]
            # executed rates: the function's FLOPs (27 C_in products per
            # output value, no padding counted) and compulsory bytes
            print(f"[conv_unit] {str(dtype)[6:]}/{str(compute)[6:]} {name}: {ca}+{cb}->{o} at "
                  f"{spatial}: y max_abs_err {err:.3e} rel {rel:.3e} (tol "
                  f"{TOL[dtype]:g}), stats rel {srel:.3e} (tol "
                  f"{CONV_STATS_TOL[dtype]:g}); kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms cuDNN conv3d {library_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}); kernel {flops / ms * 1e-9:.1f} TFLOP/s "
                  f"{nbytes / ms * 1e-6:.1f} GB/s, {bound_ms / ms * 100:.1f}% of its bound "
                  f"{'ok' if ok else 'TOO FAR'}", flush=True)
            if not ok:
                fail(f"conv unit disagrees with plain at {dtype}/{compute} {name}")
    print(f"[conv_unit] one window's 7 bf16 units: kernel {summary.ms:.4f} ms, "
          f"plain {summary.plain_ms:.4f} ms, cuDNN conv3d alone "
          f"{summary.library_ms:.4f} ms, bound {summary.bound_ms:.4f} ms "
          f"(kernel at {summary.bound_ms / summary.ms * 100:.1f}% of it)", flush=True)
    return summary


def phase_stack_vs_plain():
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    summary = Summary()
    for dtype in (torch.float32, torch.bfloat16):
        for n, c in STACK_SHAPES:
            for layers in (1, 7):
                rnd = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
                A = (rnd(layers, c, 6 * c) / c ** 0.5).to("cuda")
                w2 = (rnd(layers, 2 * c, c) / (2 * c) ** 0.5).to("cuda")
                vecs = rnd(layers, 16, 2 * c) * 0.1
                vecs[:, 6] += 1.0
                vecs[:, 8] += 1.0
                vecs = vecs.to("cuda")
                x = rnd(1, n, c).to("cuda", dtype)
                heads = c // fs.D_K
                got = fs.fused_transformer_stack(x, A, w2, vecs, heads)
                want = fs.fused_transformer_stack_reference(x, A, w2, vecs, heads)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != x.shape:
                    fail(f"stack output {got.dtype} {tuple(got.shape)}")
                err, rel = rel_err(got, want)
                summary.max_abs_err = max(summary.max_abs_err, err)
                ms, plain_ms = pkkp(
                    lambda: fs.fused_transformer_stack_reference(x, A, w2, vecs, heads),
                    lambda: fs.fused_transformer_stack(x, A, w2, vecs, heads))
                flops = layers * n * (16 * c * c + 4 * c * fs.D_K)
                nbytes = (2 * x.element_size() * n * c
                          + 4 * (A.numel() + w2.numel() + vecs.numel()))
                bound_ms, bound_by = bound(flops, nbytes, dtype)
                summary.add(dtype, 1, ms, plain_ms, flops, nbytes)
                ok = rel <= STACK_TOL[dtype]
                # executed rate: the function's FLOPs (the products of every
                # layer) over the kernel's time
                print(f"[fused_stack] {str(dtype)[6:]:8s} N={n} C={c} L={layers}: "
                      f"max_abs_err {err:.3e} rel {rel:.3e} (tol "
                      f"{STACK_TOL[dtype]:g}) kernel {ms:.4f} ms plain "
                      f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}); kernel "
                      f"{flops / ms * 1e-9:.1f} TFLOP/s, {bound_ms / ms * 100:.1f}% of its "
                      f"bound {'ok' if ok else 'TOO FAR'}", flush=True)
                if not ok:
                    fail(f"stack disagrees with plain at {dtype} {(n, c, layers)}")
    print(f"[fused_stack] one window's 8 bf16 stack calls: kernel {summary.ms:.4f} ms, "
          f"plain {summary.plain_ms:.4f} ms, bound {summary.bound_ms:.4f} ms (kernel at "
          f"{summary.bound_ms / summary.ms * 100:.1f}% of it); no single PyTorch call "
          f"computes a transformer stack", flush=True)
    return summary


def backward_errors(got, want):
    """Largest (max |got - want|, that over max |want|) of dq, dk, dv. A
    gradient below 1e-3 of the largest of the three is zero in exact
    arithmetic (dk of one token, whose token softmax is 1: two equal sums
    cancel) and is held against a tenth of the largest instead, the scale
    of the terms that cancel."""
    top = max(w.float().abs().max().item() for w in want)
    worst = (0.0, 0.0)
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        scale = scale if scale >= 1e-3 * top else 1e-1 * top
        worst = max(worst, (err, err / scale), key=lambda e: e[1])
    return worst


def phase_attention_backward_vs_plain():
    gen = torch.Generator(device="cpu").manual_seed(SEED + 4)
    summary = Summary()
    for dtype in (torch.float32, torch.bfloat16):
        for (bh, n, d), layout in attention_cases(TRAIN_SHAPES):
            q, k, v, g = attention_inputs(4, bh, n, d, layout, dtype, gen)
            got = fused.linear_attention_backward(q, k, v, g)
            want = fused.linear_attention_backward_reference(q, k, v, g)
            torch.cuda.synchronize()
            if any(a.dtype != dtype or a.shape != q.shape for a in got):
                fail(f"backward kernel output {[(a.dtype, tuple(a.shape)) for a in got]}")
            err, rel = backward_errors(got, want)
            summary.max_abs_err = max(summary.max_abs_err, err)
            ms, plain_ms = pkkp(
                lambda: fused.linear_attention_backward_reference(q, k, v, g),
                lambda: fused.linear_attention_backward(q, k, v, g), 20)
            nbytes = 7 * bh * n * d * q.element_size()  # read q, k, v, g; write dq, dk, dv
            flops = 10 * bh * n * d * d                 # five (N x d) by (d x d) products
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            if layout == "heads":
                summary.add(dtype, 8, ms, plain_ms, flops, nbytes)
            ok = rel <= TOL[dtype]
            label = f"{str(dtype)[6:]:8s} {layout:10s} BH={bh} N={n} d={d}"
            print(f"[attention_bwd] {label}: max_abs_err {err:.3e} rel {rel:.3e} (tol "
                  f"{TOL[dtype]:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'TOO FAR'}",
                  flush=True)
            if not ok:
                fail(f"backward kernel disagrees with plain at {dtype} {layout} {(bh, n, d)}")
            check_launches("attention_bwd", label, cuda_launches(
                lambda: fused.linear_attention_backward(q, k, v, g), 3))
    print(f"[attention_bwd] one train step's 32 bf16 calls (the model's layout): kernel "
          f"{summary.ms:.4f} ms, plain {summary.plain_ms:.4f} ms, bound "
          f"{summary.bound_ms:.4f} ms; no single PyTorch call computes this backward",
          flush=True)
    return summary


# max |kernel - plain| <= tol * max |plain| for the probes: bf16 outputs as
# TOL; variant E of the dot probe 1e-2 (a bf16 rounding after every tap, so
# a one-ulp difference carries into the next sum; measured on an H100:
# 3.4e-3), and its output nearer the bf16-accumulated sum than the
# f32-accumulated one (dot_probe.E_ROUNDING_SHARE); lane sums 1e-5 of each
# sum's max |plain| (f32 sums in another order).
PROBE_E_TOL = 1e-2
LANE_SUMS_TOL = 1e-5
# the row-offset probe's variant on the probes' path and the kernels line
ROW_OFFSET_MAIN = "C. 9 dots, misaligned offsets (k*577)"


def lane_sums_error(got, want):
    """The larger (max |err|, rel) of the sums and the sums of squares."""
    return max((rel_err(got[:, :, i], want[:, :, i]) for i in (0, 1)), key=lambda e: e[1])


def probe_inputs():
    """Each probe's bf16 inputs at its TPU probe's main shape, on the card."""
    device = "cuda"
    return {"dot": dot_probe.inputs(dot_probe.GROUPS, dot_probe.M, 128, 9, 64, device),
            "rows": rowoffset_probe.inputs(rowoffset_probe.GROUPS, rowoffset_probe.M_PAD,
                                           device),
            "inner": inner_probe.inputs(inner_probe.BATCH, inner_probe.HBO, device),
            "halo": conv_prototype.inputs(conv_prototype.SHAPE, conv_prototype.N_OUT, device),
            "conv_rows": conv_retired.inputs(conv_retired.SHAPES[0][1],
                                             conv_retired.SHAPES[0][2], device),
            "stats": in_stats_probe.inputs(in_stats_probe.SHAPES[1][1], device)}


def probe_path(inp):
    """Each probe's entry point at its main shape, as a user of ``python -m
    lintransunet_tpu_torch.experiments.<probe>`` calls it (phase 9)."""
    (x, w), (xr, wr), (z, kp, ku, kd) = inp["dot"], inp["rows"], inp["inner"]
    (xc, kc), (xp, kr, br), xs = inp["halo"], inp["conv_rows"], inp["stats"]
    return {"tap_sum": lambda: dot_probe.tap_sum(x, w),
            "row_offset_sum": lambda: rowoffset_probe.row_offset_sum(
                xr, wr, rowoffset_probe.OFFSETS[ROW_OFFSET_MAIN]),
            "inner_step": lambda: inner_probe.inner_step(z, kp, ku, kd, inner_probe.HBO),
            "conv3d_cl": lambda: conv_prototype.conv3d_cl(xc, kc),
            "conv3d_cl_rows": lambda: conv_retired.conv3d_cl_rows(xp, kr, br),
            "lane_sums": lambda: in_stats_probe.lane_sums(xs)}


def probe_cases(inp):
    """One dict per probe comparison on ``probe_inputs()`` (and #7 also in
    f32): the kernel's call, its plain version, the library call (or None),
    (FLOPs the function needs, compulsory bytes), the tolerance, whether it
    is the probe's row of the kernels line, and whether its card time is
    printed beside its events (``card``: the tap sums, host-bound by events)."""
    bf16, f32, device = torch.bfloat16, torch.float32, "cuda"
    cases = []
    x, w = inp["dot"]
    cases.append(dict(
        name="tap_sum", what="#10 variant A, 9 taps (16 x 4096, 128) @ (128, 64)",
        run=lambda: dot_probe.tap_sum(x, w), plain=lambda: dot_probe.tap_sum_reference(x, w),
        library=lambda: dot_probe.library(x, w), costs=dot_probe.tap_sum_costs(x, w),
        tol=TOL[bf16], dtype=bf16, entry=True, card=True))
    cases.append(dict(
        name="tap_sum", what="#10 variant E, bf16 accumulation",
        run=lambda: dot_probe.tap_sum(x, w, acc_dtype=bf16),
        plain=lambda: dot_probe.tap_sum_reference(x, w, acc_dtype=bf16),
        f32_acc=lambda: dot_probe.tap_sum_reference(x, w), library=None,
        costs=dot_probe.tap_sum_costs(x, w, acc_dtype=bf16), tol=PROBE_E_TOL, dtype=bf16,
        card=True))
    xr, wr = inp["rows"]
    for variant, offsets in rowoffset_probe.OFFSETS.items():
        cases.append(dict(
            name="row_offset_sum", what=f"#8 {variant}",
            run=lambda o=offsets: rowoffset_probe.row_offset_sum(xr, wr, o),
            plain=lambda o=offsets: rowoffset_probe.row_offset_sum_reference(xr, wr, o),
            library=rowoffset_probe.library_call(xr, wr, offsets),
            costs=dot_probe.tap_sum_costs(xr, wr, rowoffset_probe.M, offsets),
            tol=TOL[bf16], dtype=bf16, entry=variant == ROW_OFFSET_MAIN, card=True))
    z, kp, ku, kd = inp["inner"]
    # F.conv3d on the same tensor: the same function but at the wrap columns
    # (no library call computes it), timed beside the kernel as a yardstick
    w_conv = inner_probe.library_weight(kp, ku, kd)
    for strategy in inner_probe.STRATEGIES:
        packed = inner_probe.pack_inner_weights(kp, ku, kd, strategy)
        cases.append(dict(
            name="inner_step", what=f"#11 {strategy}, {inner_probe.BATCH} windows at "
                                    f"hbo={inner_probe.HBO}",
            run=lambda st=strategy, w=packed: inner_probe.inner_step_packed(
                z, w, inner_probe.HBO, st),
            plain=lambda: inner_probe.inner_step_reference(z, kp, ku, kd, inner_probe.HBO),
            library=None, yardstick=lambda: inner_probe.library_conv(z, w_conv),
            costs=inner_probe.costs(inner_probe.BATCH, inner_probe.HBO),
            tol=TOL[bf16], dtype=bf16, entry=strategy == "dots27", card=True))
    xc, kc = inp["halo"]
    kc_lib = conv_prototype.library_weight(kc)
    cases.append(dict(
        name="conv3d_cl", what=f"#6, x {conv_prototype.SHAPE} -> "
                               f"{conv_prototype.N_OUT}",
        run=lambda: conv_prototype.conv3d_cl(xc, kc),
        plain=lambda: conv_prototype.conv3d_cl_reference(xc, kc),
        library=lambda: conv_prototype.library_conv(xc[None], kc_lib),
        costs=conv_prototype.conv_costs(xc, kc), tol=TOL[bf16], dtype=bf16, entry=True))
    label, shape, n_out = conv_retired.SHAPES[0]
    for dtype in (bf16, f32):
        xp, kr, br = (inp["conv_rows"] if dtype == bf16
                      else conv_retired.inputs(shape, n_out, device, dtype))
        kr_lib, br_lib = conv_prototype.library_weight(kr), br.to(dtype)
        cases.append(dict(
            name="conv3d_cl_rows", what=f"#7 with bias, {label} {shape} -> {n_out} "
                                        f"{str(dtype)[6:]}",
            run=lambda xp=xp, kr=kr, br=br: conv_retired.conv3d_cl_rows(xp, kr, br),
            plain=lambda xp=xp, kr=kr, br=br: conv_retired.conv3d_cl_rows_reference(xp, kr, br),
            library=lambda xp=xp, k=kr_lib, b=br_lib: conv_prototype.library_conv(xp, k, b),
            costs=conv_prototype.conv_costs(xp, kr, dtype), tol=TOL[dtype], dtype=dtype,
            entry=dtype == bf16))
    label, shape, ch, n, sub = in_stats_probe.SHAPES[1]
    xs = inp["stats"]
    cases.append(dict(
        name="lane_sums", what=f"#9 {label} {shape}",
        run=lambda: in_stats_probe.lane_sums(xs),
        plain=lambda: in_stats_probe.lane_sums_reference(xs),
        library=lambda: in_stats_probe.library_stats(xs, ch, n, sub),
        costs=(3 * xs.numel(), 2 * xs.numel() + 4 * 2 * xs.numel() // (
            in_stats_probe.HBLK * shape[2])),
        tol=LANE_SUMS_TOL, dtype=bf16, entry=True, compare=lane_sums_error))
    return cases


def phase_probes_vs_plain(cases):
    """Each probe kernel against its plain version, timed beside the library
    call and the bound; returns {name: Summary} of the kernels line's rows."""
    summaries = {}
    for case in cases:
        got, want = case["run"](), case["plain"]()
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{case['what']}: kernel output {got.dtype} {tuple(got.shape)}, plain "
                 f"{want.dtype} {tuple(want.shape)}")
        err, rel = case.get("compare", rel_err)(got, want)
        rounding = ""
        if "f32_acc" in case:
            share = dot_probe.bf16_rounding_share(got, want, case["f32_acc"]())
            rounding = (f" rounding share {share:.3e} (at most "
                        f"{dot_probe.E_ROUNDING_SHARE:g})")
            if share > dot_probe.E_ROUNDING_SHARE:
                fail(f"{case['what']}: the kernel's output sits at {share:.3f} of the gap "
                     f"between the bf16- and the f32-accumulated sums: no bf16 rounding")
        del got, want
        # kernel and library call timed alike: warmed, then 10-call windows
        # in turns plain, kernel, library, library, kernel, plain (#11: its
        # F.conv3d yardstick in the library call's place, outside the
        # kernels line)
        other = case["library"] or case.get("yardstick")
        timed = [case["plain"], case["run"]] + ([other] if other else [])
        plain_ms, ms, *lib = in_turns(timed, ITERS)
        other_ms = lib[0] if lib else None
        library_ms = other_ms if case["library"] else None
        flops, nbytes = case["costs"]
        bound_ms, bound_by = bound(flops, nbytes, case["dtype"])
        ok = rel <= case["tol"]
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        rates = f" ({flops / ms * 1e-9:.1f} TFLOP/s" + (
            "" if library_ms is None else f", library {flops / library_ms * 1e-9:.1f}") + ")"
        yard = ("" if "yardstick" not in case else
                f" F.conv3d yardstick (the same function but at the wrap columns) "
                f"{other_ms:.4f} ms")
        print(f"[probe] {case['name']} {case['what']}: max_abs_err {err:.3e} rel "
              f"{rel:.3e} (tol {case['tol']:g}){rounding} kernel {ms:.4f} ms{rates} plain "
              f"{plain_ms:.4f} ms library {lib}{yard} bound {bound_ms:.4f} ms ({bound_by}), "
              f"kernel at {bound_ms / ms * 100:.1f}% of it {'ok' if ok else 'TOO FAR'}",
              flush=True)
        if case.get("card"):  # host-bound by events: the card's own time beside them
            label = "library" if case["library"] else "F.conv3d"
            print(f"[probe] {case['name']} {case['what']}:"
                  f"{card_line(case['run'], other, label=label)}", flush=True)
        if not ok:
            fail(f"probe kernel disagrees with plain: {case['name']} {case['what']}")
        if case.get("entry"):
            summary = Summary()
            summary.max_abs_err = err
            summary.add(torch.bfloat16, 1, ms, plain_ms, flops, nbytes, library_ms)
            summaries[case["name"]] = summary
    return summaries


def phase_probe_path(path):
    """Phase 9: every probe's entry point once; each launches its kernel
    exactly once and gives finite output."""
    reset_launch_counts()
    outs = {name: call() for name, call in path.items()}
    torch.cuda.synchronize()
    launches = launch_counts()
    for name, out in outs.items():
        if not bool(torch.isfinite(out).all()):
            fail(f"the probe {name} gave non-finite output")
    print(f"[probes] launches {launches} (want {PER_WINDOW['probes']}); output shapes "
          f"{ {name: tuple(out.shape) for name, out in outs.items()} }", flush=True)
    if launches != PER_WINDOW["probes"]:
        fail(f"the probes' path launched {launches}, not {PER_WINDOW['probes']}")
    return launches


def build_model(attention_impl="kernel", dtype=torch.bfloat16, state=None,
                fused_config=False):
    model = MaskTransUnet(**FLAGSHIP, dtype=dtype, attention_impl=attention_impl,
                          fused_s1=fused_config, fused_stack=fused_config)
    if state is None:
        init_random_(model, torch.Generator(device="cpu").manual_seed(SEED))
    else:
        model.load_state_dict(state)
    return model.eval()


COUNTED = {"linear_attention": fused.linear_attention,
           "linear_attention_backward": fused.linear_attention_backward,
           "conv_unit": cu.conv_unit,
           "fused_stack": fs.fused_transformer_stack,
           "tap_sum": dot_probe.tap_sum,
           "row_offset_sum": rowoffset_probe.row_offset_sum,
           "inner_step": inner_probe.inner_step_packed,
           "conv3d_cl": conv_prototype.conv3d_cl,
           "conv3d_cl_rows": conv_retired.conv3d_cl_rows,
           "lane_sums": in_stats_probe.lane_sums}


def launch_counts():
    return {name: fn.launches for name, fn in COUNTED.items()}


def reset_launch_counts():
    for fn in COUNTED.values():
        fn.launches = 0


def phase_slice(model, volumes, path):
    """Serve ``volumes`` through ``make_eval_runner``; returns the kernels'
    launch counts, which must be PER_WINDOW[path] x windows."""
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
    return launches


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
    returns the launch counts of the run and the step's ms."""
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
    fused._forward_kernel = recording
    try:
        loss, _ = step(state, images, labels, DYNAMIC_WEIGHT, gen)
    finally:
        fused._forward_kernel = forward
    finite = torch.isfinite(loss) & grads_finite(model)
    per_step = [launch_counts()]
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
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = launch_counts()
    if not bool(finite):
        fail("a train step gave a non-finite loss or gradient")
    if any(c != PER_WINDOW["train"] for c in per_step):
        fail(f"train steps launched {per_step}, not {PER_WINDOW['train']} each")
    print(f"[train] {TRAIN_STEPS + 1} steps of the flagship ({n_params:,} f32 "
          f"parameters, bf16 compute) on a {'x'.join(map(str, PATCH[2:]))} patch: "
          f"{ms:.2f} ms per step (mean of {TRAIN_STEPS}, one synchronise), peak "
          f"{peak:.2f} GiB; last loss {loss.item():.6f}; step {state.step}, "
          f"optimizer updates {state.gradient_step}; launches {launches}", flush=True)
    print(f"[train] last step's logs: "
          f"{ {k: round(v.item(), 6) for k, v in logs.items()} }", flush=True)
    return launches


def train_step_grads(attention_impl, dtype, images, labels, criterions,
                     dynamic_weight=DYNAMIC_WEIGHT, jitter=0.0):
    """(loss, {name: gradient}) of one train step from the seed's weights,
    each weight moved by ``jitter`` relative (seeded normal) if given."""
    model = build_model(attention_impl, dtype).train()
    if jitter:
        gen = torch.Generator(device="cpu").manual_seed(SEED + 7)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + jitter * torch.randn(p.shape, generator=gen).to(p.device))
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


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on an NVIDIA GPU")
    # f32 comparisons are f32 throughout; the bf16 model is unaffected
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    summaries = {"linear_attention": phase_attention_vs_plain(),
                 "conv_unit": phase_conv_vs_plain(),
                 "fused_stack": phase_stack_vs_plain(),
                 "linear_attention_backward": phase_attention_backward_vs_plain()}
    # the cases hold the probes' inputs: drop them all before the model phases
    cases = probe_cases(probe_inputs())
    summaries.update(phase_probes_vs_plain(cases))
    del cases
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    volumes = [torch.randn(VOLUME, generator=gen).to("cuda") for _ in range(N_VOLUMES)]
    window = volumes[0][..., :64].contiguous()
    default = build_model()
    launches = {"default": phase_slice(default, volumes, "default")}
    phase_end_to_end(default, window)
    fused_model = build_model(fused_config=True)
    launches["fused"] = phase_slice(fused_model, volumes, "fused")
    phase_fused_vs_default(default, fused_model, window)
    del default, fused_model, volumes
    torch.cuda.empty_cache()

    images, labels, criterions = train_inputs()
    launches["train"] = phase_train(images, labels, criterions)
    phase_train_vs_plain(images, labels, criterions)
    del images, labels
    torch.cuda.empty_cache()
    launches["probes"] = phase_probe_path(probe_path(probe_inputs()))

    # name: (source, the TPU kernel it replaces, the path whose launches it reports)
    sources = {"linear_attention": ("linear_attention", "pallas_attention.py:126", "default"),
               "conv_unit": ("conv_unit", "pallas_conv.py:625", "fused"),
               "fused_stack": ("fused_stack", "pallas_layer.py:281", "fused"),
               "linear_attention_backward": ("linear_attention",
                                             "pallas_attention.py:260", "train")}
    entries = []
    for name, (source, replaces, path) in sources.items():
        entry = {"name": name, "route": "cuda",
                 "source": f"lintransunet_tpu_torch/csrc/{source}.cu",
                 "replaces": f"lintransunet_tpu/ops/{replaces}", "path": path}
        if name == "linear_attention":
            entry["also_replaces"] = ["lintransunet_tpu/ops/pallas_attention.py:206",
                                      "lintransunet_tpu/ops/pallas_attention.py:233"]
        entry.update(summaries[name].entry(launches[path][name]))
        entries.append(entry)
    for name, (source, replaces) in PROBES.items():
        entry = {"name": name, "route": "cuda",
                 "source": f"lintransunet_tpu_torch/csrc/{source}.cu",
                 "replaces": replaces, "path": "probes"}
        entry.update(summaries[name].entry(launches["probes"][name]))
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
