"""Tensor-core rate at the conv's GEMM shapes: the H100 counterpart of
``experiments/pallas_dot_probe.py`` (``bench``, pallas_call at :41).

``tap_sum(x, w, offsets, m, acc_dtype)`` computes

    out[g] = sum_t x[g, off_t : off_t + m] @ w[t]

(rows outside x read as zero) in f32, stored as bf16: with offsets 0 it is
the TPU probe's kernel. ``acc_dtype=torch.bfloat16`` rounds each product to
bf16 and sums in bf16, as variant E does: Hopper's tensor cores accumulate
bf16 products only in f32, so this is a rounding after each tap, not a
cheaper multiply-add. CPU tensors take ``tap_sum_reference``; CUDA tensors
launch ``taps_fold`` in ``csrc/probe_taps.cu`` or raise. The same kernel
serves ``rowoffset_probe``; ``inner_probe`` runs the file's ``inner_taps``.

The kernel folds the taps per distinct offset (``tap_plan`` lays out the
products, ``fold_taps_reference`` is the fold's plain version): the taps at
one offset sum, in f32, to one weight split into bf16 hi and lo, two
products that hold the result to ~2^-16 of the f32 sum of the exact
products, so variant A (9 taps at offset 0) runs 2 products, not 9. A call
is two CUDA launches and counts one: the fold writes the folded weights to
a scratch kept per (device, stream), then ``taps_fold``, under programmatic
dependent launch, copies its column tile's weights into shared memory and
stages, per distinct offset and 64-wide K chunk, the 128 rows its tile
reads there, for `wgmma`.

``python -m lintransunet_tpu_torch.experiments.dot_probe`` times variants
A-F of the TPU probe and the conv unit's own GEMM shapes on the card, each
beside ``torch.einsum`` timed alike (variant E beside none: no PyTorch call
rounds after each tap): by events over calls back to back from the host,
then by the card's own time with the calls queued behind a sleep, the
host's time a call, and each launch's device time.
"""

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.experiments import common

MAX_TAPS = 32
MAX_K = 2048
# taps_fold: 128 output rows a tile, 64-wide K chunks (A sub-tiles of 16 KB)
TILE_ROWS, K_TILE, THREADS = 128, 64, 256
A_TILE_BYTES = TILE_ROWS * K_TILE * 2
TAP_SMEM = common.SMEM_LIMIT - 1024  # the ring and the weights; the fold's barrier above
FOLD, WHOLE, SPLIT = 0, 1, 2  # how a tile's items run (csrc/probe_taps.cu TapMode)
AS_IS, HI, LO = 0, 1, 2       # a product's weight (Part)
PLAN_HEADER, PLAN_TABLE = 20, 32


def shifted_rows(x: torch.Tensor, off: int, m: int) -> torch.Tensor:
    """Rows [off, off + m) of x along dim 1, zeros where they fall outside."""
    start, stop = max(0, off), min(x.shape[1], off + m)
    if start >= stop:
        return x.new_zeros((x.shape[0], m) + tuple(x.shape[2:]))
    part = x[:, start:stop]
    lo, hi = start - off, off + m - stop
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


def fold_taps_reference(w, offsets):
    """What the fold launch (``taps_fold_weights``) computes: (distinct
    offsets in order of first appearance, hi, lo), hi and lo (D, K, N) bf16.
    A lone tap's weight is hi as it is (lo 0); two or more taps sum in f32,
    in tap order, to s, and hi = bf16(s), lo = bf16(s - hi). w: (T, K, N)
    bf16."""
    distinct = list(dict.fromkeys(int(o) for o in offsets))
    his, los = [], []
    for off in distinct:
        taps = [t for t, o in enumerate(offsets) if o == off]
        if len(taps) == 1:
            his.append(w[taps[0]])
            los.append(torch.zeros_like(w[0]))
            continue
        acc = torch.zeros(w.shape[1:], dtype=torch.float32, device=w.device)
        for t in taps:
            acc = acc + w[t].float()
        hi = acc.to(torch.bfloat16)
        his.append(hi)
        los.append((acc - hi.float()).to(torch.bfloat16))
    return distinct, torch.stack(his), torch.stack(los)


@dataclasses.dataclass(frozen=True)
class TapPlan:
    """How ``taps_fold`` runs one signature: the column tile, the mode,
    whether the weights stream through a ring (they do not fit in shared
    memory at any column tile), the A ring's slots and 64-wide sub-tiles a
    slot, items a tile, the distinct offsets, the products (distinct offset
    index, part, taps), the shared memory the ring and the weights take, the
    elements of the folded weights' scratch, and the C plan."""
    nt: int
    mode: int
    streamed: bool
    slots: int
    nsub: int
    items: int
    offsets: tuple
    products: tuple
    smem: int
    folded: int
    ints: object = dataclasses.field(compare=False, repr=False)


def column_tiles(n):
    """The column tiles that divide n, largest first."""
    nt = n_tile(n)
    while nt >= 16:
        yield nt
        nt //= 2


@functools.lru_cache(maxsize=256)
def tap_plan(k: int, n: int, offsets: tuple, bf16_acc: bool) -> TapPlan:
    """The products and the shared-memory layout of one ``taps_fold`` call.

    Summed in f32, each distinct offset is one product (a lone tap) or two
    (hi and lo of its taps' sum). With bf16 accumulation every tap is a
    product, in tap order, and the offsets that stage A are the runs of
    consecutive taps at one offset (all 9 of variant E are one run), so the
    bf16 sum rounds in the function's order. The folded weights (products x
    K padded to 64 x the column tile, bf16) stay resident beside an A ring
    of 2-4 slots of 16 KB (and, with bf16 accumulation, the running sums),
    at the largest column tile where they fit, with the most slots that fit
    (bf16 accumulation first tries the whole of K in one item, two slots);
    else each item's tiles stream through a ring of two slots more than
    A's 3 or 2."""
    if bf16_acc:
        runs = [[offsets[0], [0]]]
        for t, off in enumerate(offsets[1:], 1):
            if off == runs[-1][0]:
                runs[-1][1].append(t)
            else:
                runs.append([off, [t]])
        distinct = tuple(off for off, _ in runs)
        d_taps = [tuple(taps) for _, taps in runs]
    else:
        distinct = tuple(dict.fromkeys(offsets))
        d_taps = [tuple(t for t, o in enumerate(offsets) if o == off) for off in distinct]
    products = []
    for d, taps in enumerate(d_taps):
        if bf16_acc:
            products += [(d, AS_IS, (t,)) for t in taps]
        elif len(taps) == 1:
            products.append((d, AS_IS, taps))
        else:
            products += [(d, HI, taps), (d, LO, taps)]
    nkc = -(-k // K_TILE)
    by_tap = SPLIT if bf16_acc else FOLD

    def layout(nt, slots, nsub, w_bytes):
        """(ring bytes, running sums' bytes, weights' offset) if they fit."""
        ring = slots * nsub * A_TILE_BYTES
        sums = nt * THREADS if bf16_acc else 0  # NT / 4 bf16 pairs a thread
        w_offset = (TAP_SMEM - w_bytes) // 1024 * 1024  # the weights at the top
        return (ring, sums, w_offset) if ring + sums <= w_offset else None

    choice = None
    for nt in column_tiles(n):
        w_bytes = len(products) * nkc * nt * K_TILE * 2
        options = ([(WHOLE, 2, nkc)] if bf16_acc and nkc <= 4 else []) + [
            (by_tap, slots, 1) for slots in (4, 3, 2)]
        for mode, slots, nsub in options:
            if layout(nt, slots, nsub, w_bytes):
                choice = (nt, mode, False, slots, nsub, w_bytes)
                break
        if choice:
            break
    if choice is None:  # each item's products (at most 2) copied in before it runs
        nt = n_tile(n)
        for slots in (3, 2):  # the weights' ring: two slots more than A's (probe_taps.cu)
            w_bytes = (slots + 2) * 2 * nt * K_TILE * 2
            if layout(nt, slots, 1, w_bytes):
                choice = (nt, by_tap, True, slots, 1, w_bytes)
                break
    nt, mode, streamed, slots, nsub, w_bytes = choice
    ring, sums, w_offset = layout(nt, slots, nsub, w_bytes)
    items = {FOLD: nkc * len(distinct), WHOLE: len(distinct), SPLIT: len(products) * nkc}[mode]
    tables = [[0] * PLAN_TABLE for _ in range(9)]
    d_off, d_p0, d_np, p_d, p_part, p_t0, p_nt, tap_idx, g_p = tables
    starts = []
    for d, taps in enumerate(d_taps):
        d_off[d] = distinct[d]
        starts.append(sum(len(t) for t in d_taps[:d]))
        tap_idx[starts[d]:starts[d] + len(taps)] = taps
    for p, (d, part, taps) in enumerate(products):
        if d_np[d] == 0:
            d_p0[d] = p
        d_np[d] += 1
        p_d[p], p_part[p], p_nt[p] = d, part, len(taps)
        p_t0[p] = starts[d] + d_taps[d].index(taps[0])
    groups = [p for p, (_, part, _) in enumerate(products) if part != LO]  # one fold each
    for g, p in enumerate(groups):
        g_p[g] = p
    header = [k, n, nt, nkc, n // nt, mode, int(streamed), slots, nsub, items, len(distinct),
              len(products), w_offset, w_bytes, int(bf16_acc), len(groups), ring, 0, 0, 0]
    values = header + [v for table in tables for v in table]
    return TapPlan(nt, mode, streamed, slots, nsub, items, distinct, tuple(products),
                   ring + sums + w_bytes, len(products) * nkc * K_TILE * n,
                   (ctypes.c_int * len(values))(*values))


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


def run_tap_sum(x, w, offsets, m, acc_dtype=torch.float32):
    """Check CUDA inputs and run the tap sum once (uncounted): the fold
    launch into a scratch of the folded weights, then ``taps_fold``."""
    check_cuda(x, w)
    check_taps(x, w, offsets, m)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("the kernel reads x and w in 16-byte pieces: both must start on a "
                         "16-byte boundary")
    if acc_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"acc_dtype must be float32 or bfloat16, not {acc_dtype}")
    from lintransunet_tpu_torch import kernels

    g, rows, k = x.shape
    n = w.shape[2]
    plan = tap_plan(k, n, tuple(offsets), acc_dtype == torch.bfloat16)
    out = torch.empty((g, m, n), dtype=x.dtype, device=x.device)
    lib = kernels.load("probe_taps")
    if x.device.index == torch.cuda.current_device():
        err = _launch(lib, x, w, out, plan, g, rows, m)
    else:
        with torch.cuda.device(x.device):
            err = _launch(lib, x, w, out, plan, g, rows, m)
    if err != 0:
        raise RuntimeError(f"probe_taps tap-sum launch failed: CUDA error {err}")
    return out


# The folded weights' scratch of each (device, stream): the fold launch
# writes it and ``taps_fold`` reads it, in stream order, so one call's use
# ends before the next call's fold starts.
_FOLDED = {}


def _launch(lib, x, w, out, plan, g, rows, m):
    stream = torch.cuda.current_stream(x.device).cuda_stream
    key = (x.device.index, stream)
    folded = _FOLDED.get(key)
    if folded is None or folded.numel() < plan.folded:
        folded = _FOLDED[key] = torch.empty(plan.folded, dtype=torch.bfloat16, device=x.device)
    return lib.pt_tap_sum(x.data_ptr(), w.data_ptr(), out.data_ptr(), folded.data_ptr(), g, rows,
                          m, plan.ints, stream)


def tap_sum(x: torch.Tensor, w: torch.Tensor, offsets: Optional[Sequence[int]] = None,
            m: Optional[int] = None, acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """sum_t x[:, off_t : off_t + m] @ w[t] (rows outside x are zero).

    x: (G, R, K) bf16; w: (T, K, N) bf16; offsets: T row offsets (default
    0); m: output rows (default R). Returns (G, m, N) bf16, summed in f32,
    or with ``acc_dtype=torch.bfloat16`` each tap rounded to bf16 and
    summed in bf16. ``tap_sum.launches`` counts launches.
    """
    offsets = [0] * w.shape[0] if offsets is None else [int(o) for o in offsets]
    m = x.shape[1] if m is None else int(m)
    if x.device.type == "cpu":
        return tap_sum_reference(x, w, offsets, m, acc_dtype)
    out = run_tap_sum(x, w, offsets, m, acc_dtype)
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


def executed_flops(x, w, m=None, offsets=None, acc_dtype=torch.float32):
    """FLOPs of the products ``taps_fold`` runs (``tap_plan``'s products over
    K, unpadded)."""
    g, rows, k = x.shape
    offsets = (0,) * w.shape[0] if offsets is None else tuple(offsets)
    products = len(tap_plan(k, w.shape[2], offsets, acc_dtype == torch.bfloat16).products)
    return 2 * g * (rows if m is None else m) * products * k * w.shape[2]


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


def measure(name, x, w, acc_dtype=torch.float32):
    """The kernel beside the einsum (f32 accumulation only), timed alike in
    turns, and cuBLAS on every tap's product: x (G M, K) @ the taps' weights
    side by side (K, T N), the tap sum left out."""
    fns = [lambda: tap_sum(x, w, acc_dtype=acc_dtype)]
    if acc_dtype == torch.float32:
        fns.append(lambda: library(x, w))
    ms, *lib_ms = common.in_turns(fns)
    flops, nbytes = tap_sum_costs(x, w, acc_dtype=acc_dtype)
    run = executed_flops(x, w, acc_dtype=acc_dtype)
    print(common.rate_line(name, ms, flops, nbytes, *lib_ms, executed_flops=run), flush=True)
    print(common.card_line(fns[0], fns[1] if lib_ms else None, kernels=True), flush=True)
    x2, w2 = x.reshape(-1, x.shape[2]), w.permute(1, 0, 2).reshape(x.shape[2], -1)
    every = 2 * x2.shape[0] * x2.shape[1] * w2.shape[1]
    gemm_ms = common.cuda_ms(lambda: x2 @ w2)
    print(common.rate_line("  cuBLAS, every tap's product, no tap sum", gemm_ms, every,
                           2 * (x.numel() + w.numel() + x2.shape[0] * w2.shape[1]),
                           executed_flops=every), flush=True)


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
        measure(name, x, w, acc)
    print(f"the conv unit's shapes, x ({CONV_GROUPS}, {M}, K) bf16 (one 128x128x64 "
          f"volume's voxels):", flush=True)
    for c_in, c_out in CONV_SHAPES:
        x, w = inputs(CONV_GROUPS, M, c_in, 27, c_out, device)
        measure(f"27 taps K={c_in} N={c_out}", x, w)
        x, w = inputs(CONV_GROUPS, M, 27 * c_in, 1, c_out, device)
        measure(f"tap-folded K={27 * c_in} N={c_out}", x, w)


if __name__ == "__main__":
    main()
