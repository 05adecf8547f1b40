"""Tensor-core rate at the conv's GEMM shapes: the H100 counterpart of
``experiments/pallas_dot_probe.py`` (``bench``, pallas_call at :41).

``tap_sum(x, w, offsets, m, acc_dtype)`` computes

    out[g] = sum_t x[g, off_t : off_t + m] @ w[t]

(rows outside x read as zero) in f32, stored as bf16: with offsets 0 it is
the TPU probe's kernel. ``acc_dtype=torch.bfloat16`` rounds each product to
bf16 and sums in bf16, as variant E does: Hopper's tensor cores accumulate
bf16 products only in f32, so this is a rounding after each tap, not a
cheaper multiply-add. CPU tensors take ``tap_sum_reference``; CUDA tensors
launch ``csrc/probe_taps.cu`` or raise. The same kernel serves
``rowoffset_probe`` and ``inner_probe``.

``python -m lintransunet_tpu_torch.experiments.dot_probe`` times variants
A-F of the TPU probe and the conv unit's own GEMM shapes on the card.
"""

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.experiments import common

KC = 32                       # K per chunk the kernel stages
MAX_TAPS = 32
MAX_K = 2048
MODES = {"window": 0, "im2col": 1, "per_tap": 2, "per_tap_bf16_acc": 3}


def shifted_rows(x: torch.Tensor, off: int, m: int) -> torch.Tensor:
    """Rows [off, off + m) of x along dim 1, zeros where they fall outside."""
    rows = x.shape[1]
    lo, hi = max(0, -off), max(0, off + m - rows)
    part = x[:, off + lo:off + m - hi]
    return F.pad(part, (0, 0, lo, hi)) if lo or hi else part


def tap_sum_reference(x, w, offsets=None, m=None, acc_dtype=torch.float32):
    """Plain PyTorch version of :func:`tap_sum`: each tap's product in f32,
    summed in f32 (or each rounded to bf16 and summed in bf16)."""
    offsets = [0] * w.shape[0] if offsets is None else list(offsets)
    m = x.shape[1] if m is None else m
    acc = None
    for t, off in enumerate(offsets):
        prod = shifted_rows(x, off, m).float() @ w[t].float()
        if acc_dtype == torch.bfloat16:
            prod = prod.bfloat16()
            acc = prod if acc is None else (acc.float() + prod.float()).bfloat16()
        else:
            acc = prod if acc is None else acc + prod
    return acc.to(x.dtype)


def n_tile(n: int) -> int:
    if n in (16, 32, 64) or n % 128 == 0:
        return min(n, 128)
    raise ValueError(f"the kernel takes N in 16, 32, 64 or a multiple of 128; got {n}")


def launch_taps(x, w, out, offsets, *, gstride, rstride, rows, k, colbase, nlo, nhi, mode):
    """Launch ``probe_taps.cu`` on CUDA tensors (the checks are the
    caller's, apart from the shared-memory limit); raise on a failed launch."""
    from lintransunet_tpu_torch import kernels

    lib = kernels.load("probe_taps")
    groups, m, n = out.shape
    tile = n_tile(n)
    span = max(offsets) - min(offsets)
    smem = lib.pt_smem_bytes(MODES[mode], tile, span)
    if smem > common.SMEM_LIMIT:
        raise ValueError(f"mode {mode!r} with an offset span of {span} rows needs "
                         f"{smem} bytes of shared memory; a block has {common.SMEM_LIMIT}")

    def ints(values):
        return (ctypes.c_int * len(values))(*values)

    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pt_forward(x.data_ptr(), w.data_ptr(), out.data_ptr(), gstride, rstride,
                             rows, m, k, n, groups, len(offsets), ints(offsets),
                             ints(colbase), ints(nlo), ints(nhi), tile, MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"probe_taps kernel launch failed: CUDA error {err}")


def check_cuda(*tensors, dtype=torch.bfloat16):
    for t in tensors:
        if t.device.type != "cuda" or t.device != tensors[0].device:
            raise ValueError("every input must be on one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"the kernel takes {dtype}, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def check_taps(x, w, offsets, m):
    if x.dim() != 3 or w.dim() != 3 or w.shape[1] != x.shape[2]:
        raise ValueError(f"x must be (G, R, K) and w (T, K, N); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if len(offsets) != w.shape[0] or not 1 <= len(offsets) <= MAX_TAPS:
        raise ValueError(f"{len(offsets)} offsets for {w.shape[0]} taps (at most {MAX_TAPS})")
    k = x.shape[2]
    if k % 8 or k > MAX_K:
        raise ValueError(f"K={k}: the kernel takes a multiple of 8 up to {MAX_K}")
    if m < 1 or x.shape[0] > 65535:
        raise ValueError(f"m={m}, G={x.shape[0]} out of the kernel's range")
    n_tile(w.shape[2])


def run_tap_sum(x, w, offsets, m, acc_dtype=torch.float32, staging="window"):
    """Check CUDA inputs and launch the kernel once (uncounted)."""
    check_cuda(x, w)
    check_taps(x, w, offsets, m)
    if acc_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"acc_dtype must be float32 or bfloat16, not {acc_dtype}")
    if staging not in ("window", "im2col", "per_tap"):
        raise ValueError(f"unknown staging {staging!r}")
    if acc_dtype == torch.bfloat16:
        if staging != "per_tap":
            raise ValueError("bf16 accumulation needs each tap's product whole: staging='per_tap'")
        mode = "per_tap_bf16_acc"
    else:
        mode = staging
    if mode == "im2col" and len(offsets) % 3:
        raise ValueError("im2col takes the taps in threes")
    g, rows, k = x.shape
    n = w.shape[2]
    chunks = -(-k // KC)
    out = torch.empty((g, m, n), dtype=x.dtype, device=x.device)
    launch_taps(x, w, out, offsets, gstride=rows * k, rstride=k, rows=rows, k=k,
                colbase=[c * KC for c in range(chunks)], nlo=[0] * chunks,
                nhi=[n] * chunks, mode=mode)
    return out


def tap_sum(x: torch.Tensor, w: torch.Tensor, offsets: Optional[Sequence[int]] = None,
            m: Optional[int] = None, acc_dtype: torch.dtype = torch.float32,
            staging: str = "window") -> torch.Tensor:
    """sum_t x[:, off_t : off_t + m] @ w[t] (rows outside x are zero).

    x: (G, R, K) bf16; w: (T, K, N) bf16; offsets: T row offsets (default
    0); m: output rows (default R). Returns (G, m, N) bf16, summed in f32,
    or with ``acc_dtype=torch.bfloat16`` each tap rounded to bf16 and
    summed in bf16. ``staging``: 'window' (the union of the taps' rows
    staged once per K chunk), 'im2col' (the same, then aligned copies of
    each three taps' rows), or 'per_tap' (each tap's rows staged anew);
    bf16 accumulation runs per tap. ``tap_sum.launches`` counts launches.
    """
    offsets = [0] * w.shape[0] if offsets is None else [int(o) for o in offsets]
    m = x.shape[1] if m is None else int(m)
    if x.device.type == "cpu":
        return tap_sum_reference(x, w, offsets, m, acc_dtype)
    out = run_tap_sum(x, w, offsets, m, acc_dtype, staging)
    tap_sum.launches += 1
    return out


tap_sum.launches = 0


def tap_sum_costs(x, w, m=None, offsets=None, acc_dtype=torch.float32):
    """(FLOPs the function needs, compulsory bytes) of one tap_sum: x and w
    read once, the output written once. Summed in f32, the taps at one
    offset fold into one weight (their sum), so it needs one product per
    distinct offset; summed in bf16 each tap's product is rounded on its
    own, so every tap counts."""
    g, rows, k = x.shape
    taps, _, n = w.shape
    m = rows if m is None else m
    offsets = [0] * taps if offsets is None else offsets
    products = taps if acc_dtype == torch.bfloat16 else len(set(offsets))
    return 2 * g * m * products * k * n, 2 * (x.numel() + w.numel() + g * m * n)


def executed_flops(x, w, m=None):
    """FLOPs of the products the kernel runs: every tap's."""
    g, rows, k = x.shape
    return 2 * g * (rows if m is None else m) * w.shape[0] * k * w.shape[2]


# Variant E's rounding must be there: the kernel's output sits nearer the
# bf16-accumulated sum than the f32-accumulated one, by this share of the
# mean gap between the two (near 0 when it rounds after each tap, near 1
# when it sums in f32).
E_ROUNDING_SHARE = 0.25


def bf16_rounding_share(got, bf16_acc, f32_acc):
    """mean |got - bf16_acc| over mean |bf16_acc - f32_acc|, in f32."""
    got, bf16_acc, f32_acc = (t.float() for t in (got, bf16_acc, f32_acc))
    return ((got - bf16_acc).abs().mean() / (bf16_acc - f32_acc).abs().mean()).item()


# The TPU probe's variants (pallas_dot_probe.py:80-86): (name, taps, K, N, acc dtype)
VARIANTS = [
    ("A. 9x (M,128)@(128,64) f32 acc", 9, 128, 64, torch.float32),
    ("B. 9x (M,128)@(128,128) f32 acc", 9, 128, 128, torch.float32),
    ("C. 1x (M,1152)@(1152,64)", 1, 1152, 64, torch.float32),
    ("D. 1x (M,1152)@(1152,128)", 1, 1152, 128, torch.float32),
    ("E. 9x (M,128)@(128,64) bf16 acc", 9, 128, 64, torch.bfloat16),
    ("F. 27x (M,128)@(128,128) f32 acc", 27, 128, 128, torch.float32),
]
GROUPS, M = 16, 4096         # the TPU probe's x (GRID, M, K)
# The conv unit's GEMM shapes (PERF.md, the fused configuration's units):
# per-tap K = C_in with N = C_out over 27 taps, and the tap-folded K = 27 C_in
# in one product, over one 128 x 128 x 64 volume's voxels (256 x 4096 rows).
CONV_GROUPS = 256
CONV_SHAPES = [(c_in, c_out) for c_in in (16, 32, 64) for c_out in (16, 32)]


def inputs(groups, rows, k, taps, n, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((groups, rows, k), generator=g).to(device, torch.bfloat16)
    w = (torch.randn((taps, k, n), generator=g) * 0.05).to(device, torch.bfloat16)
    return x, w


def library(x, w):
    """One PyTorch call with the same function at offsets 0."""
    return torch.einsum("gmk,tkn->gmn", x, w)


def measure(name, x, w, acc_dtype=torch.float32, staging="window"):
    """The kernel, the einsum, and cuBLAS on the same products: x (G M, K)
    @ the taps' weights side by side (K, T N), the tap sum left out."""
    ms = common.cuda_ms(lambda: tap_sum(x, w, acc_dtype=acc_dtype, staging=staging))
    lib_ms = common.cuda_ms(lambda: library(x, w))
    flops, nbytes = tap_sum_costs(x, w, acc_dtype=acc_dtype)
    run = executed_flops(x, w)
    print(common.rate_line(name, ms, flops, nbytes, lib_ms, executed_flops=run), flush=True)
    x2, w2 = x.reshape(-1, x.shape[2]), w.permute(1, 0, 2).reshape(x.shape[2], -1)
    gemm_ms = common.cuda_ms(lambda: x2 @ w2)
    print(common.rate_line("  cuBLAS, the same products without the tap sum", gemm_ms,
                           run, 2 * (x.numel() + w.numel() + x2.shape[0] * w2.shape[1]),
                           executed_flops=run), flush=True)


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    if device.type == "cpu":
        for name, taps, k, n, acc in VARIANTS:
            x, w = inputs(2, 256, k, taps, n, device)
            out = tap_sum(x, w, acc_dtype=acc)
            print(f"{name:<40s} plain, x {tuple(x.shape)}: out {tuple(out.shape)} "
                  f"max |out| {out.float().abs().max().item():.3f}", flush=True)
        return
    print(f"variants of the TPU probe, x ({GROUPS}, {M}, K) bf16:", flush=True)
    for name, taps, k, n, acc in VARIANTS:
        x, w = inputs(GROUPS, M, k, taps, n, device)
        stagings = ("per_tap",) if acc == torch.bfloat16 else ("window", "per_tap")
        for staging in stagings:
            measure(f"{name} [{staging}]", x, w, acc, staging)
    print(f"the conv unit's shapes, x ({CONV_GROUPS}, {M}, K) bf16 (one 128x128x64 "
          f"volume's voxels):", flush=True)
    for c_in, c_out in CONV_SHAPES:
        x, w = inputs(CONV_GROUPS, M, c_in, 27, c_out, device)
        measure(f"27 taps K={c_in} N={c_out}", x, w)
        x, w = inputs(CONV_GROUPS, M, 27 * c_in, 1, c_out, device)
        measure(f"tap-folded K={27 * c_in} N={c_out}", x, w)


if __name__ == "__main__":
    main()
