"""Do InstanceNorm statistics stream at HBM rate: the H100 counterpart of
``experiments/in_stats_probe.py`` (``_pallas_lane_sums``, pallas_call at
:90).

``lane_sums(x, scale, hblk)`` takes x (ND, H, W, L) bf16 and returns the
per-lane partial (sum, sum of squares) of x * scale over each block of
``hblk`` rows of H and all of W: (ND, H / hblk, 2, L) f32
(``csrc/probe_stats.cu``). ``stats_from_lane_sums`` finishes them into
per-(volume, channel) (mean, rstd) as the TPU probe's ``stats_pallas``;
``stats_lane`` and ``finish`` are the port's copies of the TPU probe's
``stats_lane`` and ``_finish``, as plain functions. A lane split ``sub``
names where the channel sits in the L lanes, e.g. (2, -1, 4) for the
paired layout (L = 2 x C x 4).

CPU tensors take ``lane_sums_reference``; CUDA tensors launch the kernel
or raise. ``python -m lintransunet_tpu_torch.experiments.in_stats_probe``
runs the TPU probe's four SHAPES on the card beside ``torch.var_mean``
over the same axes; the bound is one read of x.
"""

import torch

from lintransunet_tpu_torch.experiments import common

EPS = 1e-5
HBLK = 8
SHAPES = [
    # (label, shape, channels, n_volumes, lane split with the channel at -1)
    ("L0dec-paired", (32, 128, 128, 256), 32, 1, (2, -1, 4)),
    ("L0-paired", (32, 128, 128, 128), 16, 1, (2, -1, 4)),
    ("L1-folded", (64, 64, 64, 128), 32, 1, (-1, 4)),
    ("L1dec-folded", (64, 64, 64, 256), 64, 1, (-1, 4)),
]


def finish(gsum, gsq, count, eps=EPS):
    """(mean, rstd) from sums over ``count`` values: single-pass variance,
    clamped at 0."""
    mean = gsum / count
    var = torch.clamp(gsq / count - mean.square(), min=0.0)
    return mean, torch.rsqrt(var + eps)


def group(sums, n, channels, sub):
    """(n, L) lane sums -> (n, channels), summing the lane split's other axes."""
    shape = tuple(channels if s == -1 else s for s in sub)
    axes = tuple(i + 1 for i, s in enumerate(sub) if s != -1)
    return sums.reshape((n,) + shape).sum(axes)


def stats_lane(x, channels, n, sub, scale=1.0):
    """Per-(volume, channel) (mean, rstd) from a reduce over the major dims
    only, then the lane regroup (the TPU probe's ``stats_lane``)."""
    nd, h, w, lanes = x.shape
    x32 = (x.float() * scale).reshape(n, nd // n, h, w, lanes)
    sums = x32.sum(dim=(1, 2, 3))
    sqs = x32.square().sum(dim=(1, 2, 3))
    count = (nd // n) * h * w * (lanes // channels)
    return finish(group(sums, n, channels, sub), group(sqs, n, channels, sub), count)


def lane_sums_reference(x, scale=1.0, hblk=HBLK):
    """Plain PyTorch version of :func:`lane_sums`."""
    nd, h, w, lanes = x.shape
    xb = (x.float() * scale).reshape(nd, h // hblk, hblk * w, lanes)
    return torch.stack([xb.sum(dim=2), xb.square().sum(dim=2)], dim=2)


def lane_sums(x: torch.Tensor, scale: float = 1.0, hblk: int = HBLK) -> torch.Tensor:
    """(ND, H, W, L) bf16 -> (ND, H / hblk, 2, L) f32 partial (sum, sum of
    squares) of x * scale. ``lane_sums.launches`` counts launches."""
    if x.dim() != 4 or x.shape[1] % hblk:
        raise ValueError(f"x must be (ND, H, W, L) with H % {hblk} == 0; got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return lane_sums_reference(x, scale, hblk)
    from lintransunet_tpu_torch import kernels

    if x.device.type != "cuda":
        raise ValueError(f"no lane-sums path for {x.device}")
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError(f"the kernel takes a contiguous bf16 x, not {x.dtype}")
    nd, h, w, lanes = x.shape
    if lanes % 8 or 2048 % lanes:
        raise ValueError(f"L={lanes}: the kernel takes a multiple of 8 dividing 2048")
    lib = kernels.load("probe_stats")
    out = torch.empty((nd, h // hblk, 2, lanes), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ps_lane_sums(x.data_ptr(), out.data_ptr(), nd, h, w, lanes, hblk,
                               float(scale), stream)
    if err != 0:
        raise RuntimeError(f"lane-sums kernel launch failed: CUDA error {err}")
    lane_sums.launches += 1
    return out


lane_sums.launches = 0


def stats_from_lane_sums(x, channels, n, sub, scale=1.0):
    """(mean, rstd) per (volume, channel) through :func:`lane_sums` (the TPU
    probe's ``stats_pallas``)."""
    nd, h, w, lanes = x.shape
    parts = lane_sums(x, scale).reshape(n, -1, 2, lanes).sum(1)
    count = (nd // n) * h * w * (lanes // channels)
    return finish(group(parts[:, 0], n, channels, sub),
                  group(parts[:, 1], n, channels, sub), count)


def library_stats(x, channels, n, sub):
    """The yardstick: one ``torch.var_mean`` over the same axes (the
    volume's positions and the lane split's other axes)."""
    nd, h, w, lanes = x.shape
    shape = tuple(channels if s == -1 else s for s in sub)
    axes = (1,) + tuple(i + 2 for i, s in enumerate(sub) if s != -1)
    return torch.var_mean(x.view((n, (nd // n) * h * w) + shape), dim=axes, correction=0)


def inputs(shape, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * 3 + 1).to(device, torch.bfloat16)


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    if device.type == "cpu":
        for label, shape, ch, n, sub in SHAPES:
            small = (shape[0] // 16, 16, 8, shape[3])
            mean, rstd = stats_from_lane_sums(inputs(small, device), ch, n, sub)
            print(f"{label:<14s} plain at {small}: mean {tuple(mean.shape)} "
                  f"|mean| max {mean.abs().max().item():.3f}")
        return
    for label, shape, ch, n, sub in SHAPES:
        x = inputs(shape, device)
        nbytes = x.numel() * 2 + 4 * 2 * x.numel() // (HBLK * shape[2])
        flops = 3 * x.numel()
        ms = common.cuda_ms(lambda: lane_sums(x))
        lib_ms = common.cuda_ms(lambda: library_stats(x, ch, n, sub))
        print(common.rate_line(f"{label} {shape} ({nbytes / 1e6:.0f} MB)", ms, flops,
                               nbytes, lib_ms), flush=True)


if __name__ == "__main__":
    main()
