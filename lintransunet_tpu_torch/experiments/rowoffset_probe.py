"""What a row offset costs the tap operand: the H100 counterpart of
``experiments/pallas_rowoffset_probe.py`` (``build`` -> ``make_kernel``,
pallas_call at :53).

``row_offset_sum(x, w, offsets, m, staging)`` is ``dot_probe.tap_sum`` at the
TPU probe's shapes: out[g] = sum_t x[g, off_t : off_t + M] @ w[t] over 9
taps, with the probe's three offset lists (A: all 0, B: k * 576, C: k * 577).

The TPU question was whether a sublane-aligned row offset feeds the matrix
unit without a copy. On the H100 the tap operand goes through shared
memory, and the TPU tile (11520 x 128 bf16, 2.9 MB) does not fit in a
block's 227 KB, so the questions become: what does an offset that is not a
multiple of 8 rows cost against an XOR-swizzled layout (``window``: the
union of the taps' rows staged once per K chunk of 32, every tap read at a
shifted row), and what does re-reading each tap's rows from L2 cost
(``per_tap``)? Variant A is the upper bound, as on the TPU.

``python -m lintransunet_tpu_torch.experiments.rowoffset_probe`` runs the
three variants in both stagings on the card.
"""

import torch

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


def row_offset_sum(x: torch.Tensor, w: torch.Tensor, offsets, m: int = M,
                   staging: str = "window") -> torch.Tensor:
    """sum_t x[:, off_t : off_t + m] @ w[t] in f32, stored as bf16.

    x: (G, R, K) bf16; w: (T, K, N) bf16. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/probe_taps.cu`` (through
    ``dot_probe.run_tap_sum``) or raise. ``row_offset_sum.launches`` counts
    this probe's launches."""
    if x.device.type == "cpu":
        return row_offset_sum_reference(x, w, offsets, m)
    out = dot_probe.run_tap_sum(x, w, [int(o) for o in offsets], m, staging=staging)
    row_offset_sum.launches += 1
    return out


row_offset_sum.launches = 0


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
    run = dot_probe.executed_flops(x, w, M)
    print(f"x ({GROUPS}, {M_PAD}, {K}) bf16, w (9, {K}, {N}), M = {M}; no single "
          f"PyTorch call computes a sum of row-shifted products", flush=True)
    for name, offsets in OFFSETS.items():
        flops, nbytes = dot_probe.tap_sum_costs(x, w, M, offsets)
        for staging in ("window", "per_tap"):
            ms = common.cuda_ms(lambda: row_offset_sum(x, w, offsets, staging=staging))
            print(common.rate_line(f"{name} [{staging}]", ms, flops, nbytes,
                                   executed_flops=run), flush=True)


if __name__ == "__main__":
    main()
