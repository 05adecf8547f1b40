"""Drive the PyTorch port's serving paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its findings; any failure exits non-zero before the
last line):

1. card: ``nvidia-smi`` name and power limit, the device name, and the
   nvcc builds of the three CUDA kernels from ``lintransunet_tpu_torch/csrc``
   (one nvcc per source, all started together) with their ptxas reports;
2. kernel vs plain, each kernel against its plain PyTorch version at the
   shapes the main paths give it, in f32 (TF32 off) and bf16, timed with
   CUDA events in turns plain, kernel, kernel, plain, beside its bound (the
   least time the card could take: the larger of the compulsory bytes at
   3.35 TB/s and the operations at 989 TFLOP/s in bf16, 67 TFLOP/s in f32):
   a. linear attention at the four attention shapes plus a ragged and a
      one-token case;
   b. the conv unit at the seven units of a window of the fused
      configuration, with ``F.conv3d`` alone (cuDNN) on the same input and
      weights timed as a yardstick;
   c. the transformer stack at the four token stacks of a window, one and
      seven layers (no single PyTorch call computes a stack);
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
   f32, the f32 foreground labels on at least 99.9% of voxels, and both
   configurations' window forward times.

The last two lines are a JSON summary of the kernels (per-window sums over
each kernel's main-path calls, bf16) and ``{"ok": true, "device": {...}}``.
Imports nothing of jax.
"""

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch import kernels
from lintransunet_tpu_torch.cli.common import EvalConfig, make_eval_runner
from lintransunet_tpu_torch.engine import make_eval_forward
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
KERNEL_NAMES = ("linear_attention", "conv_unit", "fused_stack")
# launches per window of each kernel on each path
PER_WINDOW = {"default": {"linear_attention": 32, "conv_unit": 0, "fused_stack": 0},
              "fused": {"linear_attention": 0, "conv_unit": 7, "fused_stack": 8}}
# (BH, N, d) of the window's attention calls: bottleneck, levels 3, 2, 1
MAIN_SHAPES = [(8, 4096, 32), (8, 2160, 32), (8, 5376, 32), (4, 28704, 32)]
EXTRA_SHAPES = [(8, 300, 32), (8, 1, 32)]
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
# 0-1 and every layer of the stacks (PERF.md holds the prediction). f32:
# summation order only.
FUSED_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
MIN_AGREEMENT = 0.999
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
ITERS = 10


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def rel_err(got, want):
    """(max |got - want|, that over max |want|) in f32."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return err, (err / scale if scale else err)


def cuda_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pkkp(plain, kern, iters=ITERS):
    """(kernel ms, plain ms): warm, then plain, kernel, kernel, plain."""
    for fn in (kern, plain):
        cuda_ms(fn, 2)
    p1, k1, k2, p2 = (cuda_ms(fn, iters) for fn in (plain, kern, kern, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flops, nbytes, dtype):
    """(ms, 'bytes' or 'operations'): the least time of the card."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
                 if "registers" in line or "spill" in line]
        print(f"[card] {name} ptxas: {' | '.join(ptxas)}", flush=True)


def phase_attention_vs_plain():
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    summary = Summary()
    for dtype in (torch.float32, torch.bfloat16):
        for bh, n, d in MAIN_SHAPES + EXTRA_SHAPES:
            q, k, v = (torch.randn((1, bh, n, d), generator=gen)
                       .to("cuda", dtype) for _ in range(3))
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
            if (bh, n, d) in MAIN_SHAPES:
                summary.add(dtype, 8, ms, plain_ms, flops, nbytes)
            ok = rel <= TOL[dtype]
            print(f"[attention] {str(dtype)[6:]:8s} BH={bh} N={n} d={d}: "
                  f"max_abs_err {err:.3e} rel {rel:.3e} (tol {TOL[dtype]:g}) "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'TOO FAR'}",
                  flush=True)
            if not ok:
                fail(f"kernel disagrees with plain at {dtype} {(bh, n, d)}")
    print(f"[attention] one window's 32 bf16 calls: kernel {summary.ms:.4f} ms, "
          f"plain {summary.plain_ms:.4f} ms, bound {summary.bound_ms:.4f} ms; "
          f"no single PyTorch call computes linear attention "
          f"(scaled_dot_product_attention is softmax attention)", flush=True)
    return summary


def phase_conv_vs_plain():
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    summary = Summary()
    for dtype in (torch.float32, torch.bfloat16):
        for name, ca, cb, o, spatial, affine in CONV_SHAPES:
            rnd = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
            w = (rnd(o, ca + cb, 3, 3, 3) / (27 * (ca + cb)) ** 0.5).to("cuda")
            xa = rnd(1, ca, *spatial).to("cuda", dtype)
            kw = dict(bias=(rnd(o) * 0.1).to("cuda"))
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
            library_ms = cuda_ms(lambda: F.conv3d(x_cat, w_dt, b_dt, 1, 1), ITERS)
            voxels = spatial[0] * spatial[1] * spatial[2]
            flops = 2 * voxels * o * 27 * (ca + cb)
            nbytes = (xa.element_size() * voxels * (ca + cb + o)
                      + 4 * (w.numel() + o + 2 * o + (2 * ca if affine else 0)))
            bound_ms, bound_by = bound(flops, nbytes, dtype)
            summary.add(dtype, 1, ms, plain_ms, flops, nbytes, library_ms)
            ok = rel <= TOL[dtype] and srel <= CONV_STATS_TOL[dtype]
            print(f"[conv_unit] {str(dtype)[6:]:8s} {name}: {ca}+{cb}->{o} at "
                  f"{spatial}: y max_abs_err {err:.3e} rel {rel:.3e} (tol "
                  f"{TOL[dtype]:g}), stats rel {srel:.3e} (tol "
                  f"{CONV_STATS_TOL[dtype]:g}); kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms cuDNN conv3d {library_ms:.4f} ms bound "
                  f"{bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'TOO FAR'}",
                  flush=True)
            if not ok:
                fail(f"conv unit disagrees with plain at {dtype} {name}")
    print(f"[conv_unit] one window's 7 bf16 units: kernel {summary.ms:.4f} ms, "
          f"plain {summary.plain_ms:.4f} ms, cuDNN conv3d alone "
          f"{summary.library_ms:.4f} ms, bound {summary.bound_ms:.4f} ms", flush=True)
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
                print(f"[fused_stack] {str(dtype)[6:]:8s} N={n} C={c} L={layers}: "
                      f"max_abs_err {err:.3e} rel {rel:.3e} (tol "
                      f"{STACK_TOL[dtype]:g}) kernel {ms:.4f} ms plain "
                      f"{plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) "
                      f"{'ok' if ok else 'TOO FAR'}", flush=True)
                if not ok:
                    fail(f"stack disagrees with plain at {dtype} {(n, c, layers)}")
    print(f"[fused_stack] one window's 8 bf16 stack calls: kernel {summary.ms:.4f} ms, "
          f"plain {summary.plain_ms:.4f} ms, bound {summary.bound_ms:.4f} ms; no "
          f"single PyTorch call computes a transformer stack", flush=True)
    return summary


def build_model(attention_impl="kernel", dtype=torch.bfloat16, state=None,
                fused_config=False):
    model = MaskTransUnet(**FLAGSHIP, dtype=dtype, attention_impl=attention_impl,
                          fused_s1=fused_config, fused_stack=fused_config)
    if state is None:
        init_random_(model, torch.Generator(device="cpu").manual_seed(SEED))
    else:
        model.load_state_dict(state)
    return model.eval()


def launch_counts():
    return {"linear_attention": fused.linear_attention.launches,
            "conv_unit": cu.conv_unit.launches,
            "fused_stack": fs.fused_transformer_stack.launches}


def reset_launch_counts():
    fused.linear_attention.launches = 0
    cu.conv_unit.launches = 0
    fs.fused_transformer_stack.launches = 0


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
    one window; bf16 labels are informational for the reason above."""
    state = default.state_dict()
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.bfloat16:
            pair = (fused_model, default)
        else:
            pair = (build_model("kernel", dtype, state, fused_config=True),
                    build_model("kernel", dtype, state))
        agreement, times = compare_builds("fused", *pair, window, dtype, FUSED_TOL)
        held = (f"need >= {MIN_AGREEMENT * 100:.1f}%" if dtype == torch.float32
                else "informational")
        print(f"[fused] {str(dtype)[6:]} window, fused vs default configuration: "
              f"foreground labels agree on {agreement * 100:.4f}% of voxels "
              f"({held}); window {times[0]:.4f} s fused, {times[1]:.4f} s "
              f"default", flush=True)
        if dtype == torch.float32 and agreement < MIN_AGREEMENT:
            fail("the fused and default configurations disagree end to end in f32")


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on an NVIDIA GPU")
    # f32 comparisons are f32 throughout; the bf16 model is unaffected
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    summaries = {"linear_attention": phase_attention_vs_plain(),
                 "conv_unit": phase_conv_vs_plain(),
                 "fused_stack": phase_stack_vs_plain()}

    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    volumes = [torch.randn(VOLUME, generator=gen).to("cuda") for _ in range(N_VOLUMES)]
    window = volumes[0][..., :64].contiguous()
    default = build_model()
    launches = {"default": phase_slice(default, volumes, "default")}
    phase_end_to_end(default, window)
    fused_model = build_model(fused_config=True)
    launches["fused"] = phase_slice(fused_model, volumes, "fused")
    phase_fused_vs_default(default, fused_model, window)

    sources = {"linear_attention": ("pallas_attention.py:126", "default"),
               "conv_unit": ("pallas_conv.py:625", "fused"),
               "fused_stack": ("pallas_layer.py:281", "fused")}
    entries = []
    for name, (replaces, path) in sources.items():
        entry = {"name": name, "route": "cuda",
                 "source": f"lintransunet_tpu_torch/csrc/{name}.cu",
                 "replaces": f"lintransunet_tpu/ops/{replaces}"}
        if name == "linear_attention":
            entry["also_replaces"] = ["lintransunet_tpu/ops/pallas_attention.py:206",
                                      "lintransunet_tpu/ops/pallas_attention.py:233"]
        entry.update(summaries[name].entry(launches[path][name]))
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
