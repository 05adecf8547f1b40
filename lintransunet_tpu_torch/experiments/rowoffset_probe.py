"""What a row offset costs the tap operand: the H100 counterpart of
``experiments/pallas_rowoffset_probe.py`` (``build`` -> ``make_kernel``,
pallas_call at :53).

``row_offset_sum(x, w, offsets, m)`` is ``dot_probe.tap_sum`` at the TPU
probe's shapes: out[g] = sum_t x[g, off_t : off_t + M] @ w[t] over 9 taps,
with the probe's three offset lists (A: all 0, B: k * 576, C: k * 577).

The TPU question was whether a sublane-aligned row offset feeds the matrix
unit without a copy. On the H100 a row of x is 2 K = 256 bytes, so every
row offset is 16-byte aligned: an offset of 577 rows is as aligned as one
of 576, and a tensor-map load (TMA) of the shifted rows into a swizzled
tile costs the same at either. Measured on an NVIDIA H100 80GB HBM3 at
700 W, card time a call (the calls queued behind a sleep,
``common.card_ms``): B (k * 576) 0.100 ms and C (k * 577) 0.100 ms,
against 0.89 ms (by events) for the first H100 kernel's window staging of
C. What costs is how often a row is read: the kernel (``taps_fold``,
``csrc/probe_taps.cu``) folds the 9 taps into one product per distinct
offset (two, hi and lo, where taps share it) and stages, per distinct
offset, only the 128 rows a tile reads there, so a row is read once per
distinct offset (from L2 after the first); A, with one distinct offset,
takes 0.056 ms. Variant A is the upper bound, as on the TPU.

``python -m lintransunet_tpu_torch.experiments.rowoffset_probe`` times the
three variants on the card, each beside one PyTorch call timed alike:
``torch.einsum`` for A, and for B and C ``F.conv1d`` with kernel 3 and
dilation 576 or 577 on the taps folded per offset (the fold, and the
transpose of x to conv1d's (G, K, R) layout that the call makes, inside
the timed call; the output left in conv1d's (G, N, M) layout, a transposed
view): by events over calls back to back from the host, then by the card's
own time, the host's time a call and each launch's device time
(``common.card_line``).
"""

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.experiments import common, dot_probe

M = 8 * 18 * 64               # output rows per tile (TH * (TW + 2) * D)
HALO = 2 * 18 * 64            # two H halo rows
M_PAD = M + HALO
K, N = 128, 64
GROUPS = 32                   # tiles per launch, the TPU probe's GRID
OFFSETS = {
    "A. 9 dots, zero offsets": [0] * 9,
    "B. 9 dots, aligned offsets (k*576)": [k * 576 for k in range(3)] * 3,
    "C. 9 dots, misaligned offsets (k*577)": [min(k * 577, HALO) for k in range(3)] * 3,
}


def row_offset_sum_reference(x, w, offsets, m=M):
    return dot_probe.tap_sum_reference(x, w, offsets, m)


def row_offset_sum(x: torch.Tensor, w: torch.Tensor, offsets, m: int = M) -> torch.Tensor:
    """sum_t x[:, off_t : off_t + m] @ w[t] in f32, stored as bf16.

    x: (G, R, K) bf16; w: (T, K, N) bf16. CPU tensors take the plain
    version; CUDA tensors launch ``taps_fold`` (``csrc/probe_taps.cu``,
    through ``dot_probe.run_tap_sum``) or raise. ``row_offset_sum.launches``
    counts this probe's launches."""
    if x.device.type == "cpu":
        return row_offset_sum_reference(x, w, offsets, m)
    out = dot_probe.run_tap_sum(x, w, [int(o) for o in offsets], m)
    row_offset_sum.launches += 1
    return out


row_offset_sum.launches = 0


def library_call(x, w, offsets, m=M):
    """One PyTorch call with the same function, as a function of no
    arguments: ``torch.einsum`` where every offset is 0; where the distinct
    offsets are 0, d, 2d, ..., ``F.conv1d`` with dilation d on the taps
    folded per offset (summed in f32, rounded to bf16, as the einsum folds
    in bf16), the fold and x's transpose inside the call."""
    distinct = sorted(set(offsets))
    if distinct == [0]:
        return lambda: torch.einsum("gmk,tkn->gmn", x[:, :m], w)
    step = distinct[1]
    if distinct != [i * step for i in range(len(distinct))]:
        raise ValueError(f"no single PyTorch call sums taps at offsets {distinct}")
    taps = [torch.tensor([t for t, o in enumerate(offsets) if o == d], device=w.device)
            for d in distinct]
    span = m + step * (len(distinct) - 1)

    def call():
        folded = torch.stack([w.index_select(0, t).float().sum(0) for t in taps]).to(w.dtype)
        y = F.conv1d(x[:, :span].transpose(1, 2), folded.permute(2, 1, 0), dilation=step)
        return y.transpose(1, 2)
    return call


def inputs(groups, rows, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((groups, rows, K), generator=g).to(device, torch.bfloat16)
    w = (torch.randn((9, K, N), generator=g) * 0.05).to(device, torch.bfloat16)
    return x, w


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    if device.type == "cpu":
        m = 288
        x, w = inputs(2, m + 40, device)
        for name, offsets in OFFSETS.items():
            small = [min(o // 32, 40) for o in offsets]
            out = row_offset_sum(x, w, small, m)
            print(f"{name:<40s} plain at offsets {small[:3]}, x {tuple(x.shape)}: out "
                  f"{tuple(out.shape)} max |out| {out.float().abs().max().item():.3f}")
        return
    x, w = inputs(GROUPS, M_PAD, device)
    print(f"x ({GROUPS}, {M_PAD}, {K}) bf16, w (9, {K}, {N}), M = {M}; library: einsum (A), "
          f"F.conv1d on the folded taps (B, C)", flush=True)
    for name, offsets in OFFSETS.items():
        flops, nbytes = dot_probe.tap_sum_costs(x, w, M, offsets)
        kernel, library = lambda: row_offset_sum(x, w, offsets), library_call(x, w, offsets)
        ms, lib_ms = common.in_turns([kernel, library])
        print(common.rate_line(name, ms, flops, nbytes, lib_ms,
                               executed_flops=dot_probe.executed_flops(x, w, M, offsets)),
              flush=True)
        print(common.card_line(kernel, library, kernels=True), flush=True)


if __name__ == "__main__":
    main()
