"""Which tap inner loop wins on the level-0 paired layout: the H100
counterpart of ``experiments/pallas_inner_probe.py`` (``run`` ->
``make_kernel``, pallas_call at :226).

``inner_step(z, kp, ku, kd, hbo, strategy)`` computes the TPU probe's
``dots27`` function, edge rows included: z (3, hbo + 2, WC, L) holds the
centre plane z[1] and its depth neighbours; with z2 = z flattened to
(3, rows, L), m = hbo * WC and s = (1 + dh) * WC + dw,

    out[r] = sum_{dh, dw} z2[1, r + s] @ kp[dh, dw]
             + [z2[0, r + s, C4:] @ ku[dh, dw] | z2[2, r + s, :C4] @ kd[dh, dw]]

with rows outside [0, rows) zero (the clipped slices that ``_dot_pad``
(:46) zero-pads), summed in f32 and stored as bf16. A batch of windows
(B, 3, hbo + 2, WC, L) runs in one launch. Three strategies of the same
function, each a mode of ``csrc/probe_taps.cu`` on the operand
ze = [z1 | z0[:, C4:] | z2[:, :C4]] (K = 2L), read in place from z:

* ``dots27``: per-tap MMA from shifted shared-memory rows; the zero
  blocks of the block-diagonal neighbour weights are skipped (27 products
  of the TPU probe: 9 of K = L, 18 of K = C4);
* ``bext_s``: a shared-memory im2col, the three dw-shifted row slices of
  each dh copied into aligned panels (K = 3 x 32 per dh and K chunk), then
  the products;
* ``kext``: the K-extension, 9 products of K = 2L against the stacked
  [kp; blockdiag(ku, kd)] weights, zero blocks included (4/3 the MACs).

The TPU probe's ``base9`` computes another function (no dw shift, no
neighbour taps); ``main()`` times it as ``dot_probe.tap_sum`` on the centre
plane. The TPU probe repeated one VMEM-resident window; one window of
1,632 output rows fills 13 blocks of 128 rows out of 132 SMs, so the
H100 probe runs BATCH independent windows.

``python -m lintransunet_tpu_torch.experiments.inner_probe`` runs them.
"""

import torch

from lintransunet_tpu_torch.experiments import common, dot_probe

L, C4, NO, WC = 128, 64, 128, 136
HBO = 12
BATCH = 64                    # windows per launch: 64 x 13 = 832 blocks
STRATEGIES = ("dots27", "bext_s", "kext")
MODE = {"dots27": "window", "bext_s": "im2col", "kext": "window"}


def _batched(z):
    if z.dim() == 4:
        z = z[None]
    if z.dim() != 5 or z.shape[1] != 3:
        raise ValueError(f"z must be (3, hbo + 2, WC, L) or (B, 3, hbo + 2, WC, L); "
                         f"got {tuple(z.shape)}")
    return z


def tap_offsets(wc):
    """Row offset of tap (dh, dw), in the order of ``pack_weights``."""
    return [(1 + dh) * wc + dw for dh in (-1, 0, 1) for dw in (-1, 0, 1)]


def inner_step_reference(z, kp, ku, kd, hbo):
    """Plain PyTorch version of the ``dots27`` function: (B, hbo * WC, NO)."""
    z = _batched(z)
    b, _, _, wc, lanes = z.shape
    c4, m = lanes // 2, hbo * wc
    z2 = z.reshape(b, 3, -1, lanes)
    acc = None
    for t, s in enumerate(tap_offsets(wc)):
        dh, dw = divmod(t, 3)
        part = dot_probe.shifted_rows(z2[:, 1], s, m).float() @ kp[dh, dw].float()
        up = dot_probe.shifted_rows(z2[:, 0, :, c4:], s, m).float() @ ku[dh, dw].float()
        dn = dot_probe.shifted_rows(z2[:, 2, :, :c4], s, m).float() @ kd[dh, dw].float()
        part = part + torch.cat([up, dn], dim=-1)
        acc = part if acc is None else acc + part
    return acc.to(z.dtype)


def pack_weights(kp, ku, kd):
    """(9, 2L, NO): tap (dh, dw)'s [kp; blockdiag(ku, kd)], the kext weights."""
    lanes, n_out = kp.shape[2], kp.shape[3]
    c4 = lanes // 2
    ke = torch.zeros((3, 3, 2 * lanes, n_out), dtype=kp.dtype, device=kp.device)
    ke[:, :, :lanes] = kp
    ke[:, :, lanes:lanes + c4, :c4] = ku
    ke[:, :, lanes + c4:, c4:] = kd
    return ke.reshape(9, 2 * lanes, n_out)


def inner_step_packed(z: torch.Tensor, ke: torch.Tensor, hbo: int,
                      strategy: str = "dots27") -> torch.Tensor:
    """The kernel on CUDA tensors, with the weights packed by
    ``pack_weights``: (B, hbo * WC, NO) bf16. Counts
    ``inner_step_packed.launches``."""
    z = _batched(z)
    dot_probe.check_cuda(z, ke)
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    b, _, hb2, wc, lanes = z.shape
    c4 = lanes // 2
    if hb2 != hbo + 2 or lanes % 64 or tuple(ke.shape) != (9, 2 * lanes, ke.shape[2]):
        raise ValueError(f"z {tuple(z.shape)}, packed weights {tuple(ke.shape)} and "
                         f"hbo={hbo} do not fit")
    n_out = ke.shape[2]
    dot_probe.n_tile(n_out)
    if n_out != lanes and strategy != "kext":
        raise ValueError("dots27 and bext_s split the output columns in halves: NO must be L")
    rows = hb2 * wc
    plane = rows * lanes
    colbase, nlo, nhi = [], [], []
    for kv in range(0, 2 * lanes, dot_probe.KC):
        if kv < lanes:                         # centre plane, all lanes
            colbase.append(plane + kv)
            nlo.append(0), nhi.append(n_out)
        elif kv < lanes + c4:                  # previous plane's upper half
            colbase.append(c4 + kv - lanes)
            nlo.append(0), nhi.append(c4 if strategy != "kext" else n_out)
        else:                                  # next plane's lower half
            colbase.append(2 * plane + kv - lanes - c4)
            nlo.append(c4 if strategy != "kext" else 0), nhi.append(n_out)
    out = torch.empty((b, hbo * wc, n_out), dtype=z.dtype, device=z.device)
    dot_probe.launch_taps(z, ke, out, tap_offsets(wc), gstride=3 * plane, rstride=lanes,
                          rows=rows, k=2 * lanes, colbase=colbase, nlo=nlo, nhi=nhi,
                          mode=MODE[strategy])
    inner_step_packed.launches += 1
    return out


inner_step_packed.launches = 0


def inner_step(z: torch.Tensor, kp: torch.Tensor, ku: torch.Tensor, kd: torch.Tensor,
               hbo: int, strategy: str = "dots27") -> torch.Tensor:
    """One conv tap step on the paired layout (see the module docstring).

    z: (3, hbo + 2, WC, L) or a batch (B, 3, hbo + 2, WC, L) bf16; kp (3, 3,
    L, NO), ku and kd (3, 3, L / 2, L / 2) bf16. Returns (B, hbo * WC, NO)
    bf16 (B = 1 for one window, as the TPU probe's (1, m, NO)). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if z.device.type == "cpu":
        return inner_step_reference(z, kp, ku, kd, hbo)
    return inner_step_packed(z, pack_weights(kp, ku, kd), hbo, strategy)


def inputs(batch, hbo, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    z = torch.randn((batch, 3, hbo + 2, WC, L), generator=g).to(device, torch.bfloat16)
    kp = (torch.randn((3, 3, L, NO), generator=g) * 0.05).to(device, torch.bfloat16)
    ku, kd = ((torch.randn((3, 3, C4, C4), generator=g) * 0.05).to(device, torch.bfloat16)
              for _ in range(2))
    return z, kp, ku, kd


def costs(batch, hbo):
    """(FLOPs, compulsory bytes) of one step of the dots27 function."""
    m = hbo * WC
    flops = 2 * batch * m * 9 * (L * NO + 2 * C4 * C4)
    nbytes = 2 * (batch * 3 * (hbo + 2) * WC * L + 9 * (L * NO + 2 * C4 * C4)
                  + batch * m * NO)
    return flops, nbytes


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    if device.type == "cpu":
        z, kp, ku, kd = inputs(1, 2, device)
        out = inner_step(z, kp, ku, kd, 2)
        print(f"dots27 plain at hbo=2, one window: out {tuple(out.shape)} max |out| "
              f"{out.float().abs().max().item():.3f}")
        return
    z, kp, ku, kd = inputs(BATCH, HBO, device)
    ke = pack_weights(kp, ku, kd)
    flops, nbytes = costs(BATCH, HBO)
    print(f"{BATCH} windows z (3, {HBO + 2}, {WC}, {L}) bf16 -> ({HBO * WC}, {NO}); "
          f"FLOPs counted as dots27's; no single PyTorch call computes the step",
          flush=True)
    for strategy in STRATEGIES:
        ms = common.cuda_ms(lambda: inner_step_packed(z, ke, HBO, strategy))
        print(common.rate_line(strategy, ms, flops, nbytes), flush=True)
    centre = z[:, 1].reshape(BATCH, -1, L).contiguous()
    offsets = [(1 + dh) * WC for dh in (-1, 0, 1) for _ in range(3)]
    kp9 = kp.reshape(9, L, NO).contiguous()
    ms = common.cuda_ms(lambda: dot_probe.tap_sum(centre, kp9, offsets, HBO * WC))
    base_flops, base_bytes = dot_probe.tap_sum_costs(centre, kp9, HBO * WC, offsets)
    print(common.rate_line("base9 (centre plane, no dw shift)", ms, base_flops, base_bytes,
                           executed_flops=dot_probe.executed_flops(centre, kp9, HBO * WC)),
          flush=True)


if __name__ == "__main__":
    main()
