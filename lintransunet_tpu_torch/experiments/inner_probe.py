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
(B, 3, hbo + 2, WC, L) runs in one launch. The kernel is ``inner_taps``
(``csrc/probe_taps.cu``), for L = NO = 128. It walks a tile of output rows
in steps (``inner_steps``): per kernel row dh and 64-lane chunk of a plane
(the centre plane's two halves, the previous plane's upper half, the next
plane's lower half: the paired layout's splice is only a coordinate) it
stages one slab of rows by TMA, and per tap dw it multiplies the slab's rows
at a shift by one packed weight tile (``pack_inner_weights``). The three
strategies of the TPU probe are three plans of that walk (``MODE``):

* ``dots27``: the three dw taps read one slab at row shifts 0, 1, 2; a
  neighbour chunk multiplies its 64 x 64 block only, into the half of the
  output it adds to (27 products of the TPU probe: 9 of K = L, 18 of K = C4);
* ``kext``: the K-extension, the same slabs against the stacked
  [kp; blockdiag(ku, kd)] weights, zero blocks included (4/3 the MACs);
* ``bext_s``: the im2col counterpart, each tap's rows staged aligned by a
  load of their own (three times the loads, no shifted read).

``inner_step_planned`` walks the same plan in PyTorch (the CPU tests hold it
to the TPU probe). The TPU probe's ``base9`` computes another function (no
dw shift, no neighbour taps); ``main()`` times it as ``dot_probe.tap_sum`` on
the centre plane (``taps_fold``: 3 distinct offsets, the taps at each folded
into hi and lo). The TPU probe repeated one VMEM-resident window; the H100
probe runs BATCH independent windows. ``main()`` also times ``F.conv3d``
(cuDNN) on the same tensor as a yardstick (``library_conv``): the same
function but at the two wrap columns of each row, where cuDNN pads with
zeros and the TPU function reads the neighbouring row's end, at twice
dots27's MACs.

The card's answer to the TPU probe's question, which in-kernel tap strategy
sustains the best rate (64 windows at hbo 12, card time, NVIDIA H100 80GB
HBM3, PERF.md row 11): ``kext`` 0.123 ms, ``dots27`` 0.140, ``bext_s``
0.162, ``F.conv3d`` 0.124. ``kext``'s products, every one m64n128k16, run
faster than ``dots27``'s, every one m64n64k16 (a third fewer MACs in twice
the instructions, a neighbour step's fragments serving one 64-column
product), and staging each tap aligned costs more than reading one slab at
three shifts.

``python -m lintransunet_tpu_torch.experiments.inner_probe`` runs them.
"""

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from lintransunet_tpu_torch.experiments import common, dot_probe

L, C4, NO, WC = 128, 64, 128, 136
HBO = 12
BATCH = 64                    # windows per launch: 64 x 9 tiles of 192 rows
STRATEGIES = ("dots27", "bext_s", "kext")
# how each strategy stages A: one slab per (dh, chunk) read at three row
# shifts, or one aligned load per tap
MODE = {"dots27": "slab", "kext": "slab", "bext_s": "per_tap"}
TILE_ROWS = 192               # output rows of a kernel tile
K_TILE = 64                   # K of an A item and of a weight tile
MAX_STEPS = 36
PLAN_HEADER = 3
ALL, LOW, HIGH = 0, 1, 2      # a step's output columns: 0..127, 0..63, 64..127
# the A items of one kernel row, in the kernel's order: (name, plane, first lane)
CHUNKS = (("centre_lo", 1, 0), ("up", 0, C4), ("centre_hi", 1, C4), ("down", 2, 0))


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


@dataclasses.dataclass(frozen=True)
class Step:
    """One step of a tile: tap (dh, dw) of one 64-lane chunk. ``new_item``:
    the step stages a new A item, rows from ``m0 + (1 + dh) * WC + row`` of
    plane ``plane``, lanes ``lane0 .. lane0 + 63``; the step reads the
    item's rows from ``shift`` on, times the weight tile at element ``woff``
    of the packed weights (``cols``: the output columns it adds to)."""
    dh: int
    dw: int
    chunk: str
    plane: int
    lane0: int
    cols: int
    new_item: bool
    row: int
    shift: int
    woff: int

    @property
    def width(self):
        """The weight tile's columns (rows of the K-major tile)."""
        return NO if self.cols == ALL else C4


@functools.lru_cache(maxsize=None)
def inner_steps(strategy):
    """The steps of one tile, in the kernel's order: for each dh, each
    chunk of ``CHUNKS``, each dw. The first step adds to every column, so
    it starts the tile's sum."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    per_tap = MODE[strategy] == "per_tap"
    steps, woff = [], 0
    for dh in (-1, 0, 1):
        for chunk, plane, lane0 in CHUNKS:
            cols = ALL if plane == 1 or strategy == "kext" else (LOW if plane == 0 else HIGH)
            for dw in (-1, 0, 1):
                step = Step(dh, dw, chunk, plane, lane0, cols, new_item=per_tap or dw == -1,
                            row=dw if per_tap else -1, shift=0 if per_tap else dw + 1,
                            woff=woff)
                steps.append(step)
                woff += step.width * K_TILE
    return tuple(steps)


def weight_elems(strategy):
    last = inner_steps(strategy)[-1]
    return last.woff + last.width * K_TILE


@functools.lru_cache(maxsize=None)
def plan_ints(strategy, wc):
    """``pt_inner_step``'s plan for windows of width wc: a header (steps,
    items, weight elements) and four tables of MAX_STEPS
    (each step's flags and first row, its weight offset; each item's first
    step), as ``InnerArgs`` in ``csrc/probe_taps.cu`` reads them."""
    steps = inner_steps(strategy)
    flags, rows, woffs, item_step = ([0] * MAX_STEPS for _ in range(4))
    items = 0
    for i, st in enumerate(steps):
        flags[i] = (int(st.new_item) | st.plane << 1 | (st.lane0 // C4) << 3 | st.cols << 4
                    | st.shift << 6)
        rows[i] = (1 + st.dh) * wc + st.row
        woffs[i] = st.woff
        if st.new_item:
            item_step[items] = i
            items += 1
    values = [len(steps), items, weight_elems(strategy)] + flags + rows + woffs + item_step
    return (ctypes.c_int * len(values))(*values)


def swizzle_rows(t):
    """Rows of 64 bf16 as 8 16-byte pieces, piece p of row n moved to p ^ (n
    % 8) (``ltu::swz``, the 128-byte swizzle); its own inverse."""
    n = t.shape[0]
    pieces = torch.arange(8, device=t.device)[None, :] ^ (torch.arange(n, device=t.device)[:, None] % 8)
    return t.reshape(n, 8, 8)[torch.arange(n, device=t.device)[:, None], pieces].reshape(n, 64)


def _weight_tile_index(step, lanes=L):
    """The flat indices into cat(kp, ku, kd, [0]) (the zero at the end) of
    one step's logical K-major tile: row n (output column) holds its 64 K."""
    kp_n, ku_n = 9 * lanes * NO, 9 * C4 * C4
    zero = kp_n + 2 * ku_n
    tap = (step.dh + 1) * 3 + step.dw + 1
    k = torch.arange(K_TILE)[None, :]
    n = torch.arange(step.width)[:, None]
    if step.plane == 1:                        # kp[tap][lane0 + k, n]
        return tap * lanes * NO + (step.lane0 + k) * NO + n
    base = kp_n + (0 if step.plane == 0 else ku_n) + tap * C4 * C4
    if step.cols != ALL:                       # ku / kd [tap][k, n]: the non-zero block
        return base + k * C4 + n
    # kext: 128 columns, the block in the half the chunk adds to
    half = n - (0 if step.plane == 0 else C4)
    inside = (half >= 0) & (half < C4)
    return torch.where(inside, base + k * C4 + half.clamp(0, C4 - 1), torch.full_like(half, zero))


@functools.lru_cache(maxsize=None)
def _pack_index(strategy, device):
    """Every packed element's flat index into cat(kp, ku, kd, [0]), made
    once per strategy and device: packing is then one gather."""
    tiles = [swizzle_rows(_weight_tile_index(st)).reshape(-1) for st in inner_steps(strategy)]
    return torch.cat(tiles).to(device)


def pack_inner_weights(kp, ku, kd, strategy="dots27"):
    """kp (3, 3, L, NO), ku and kd (3, 3, C4, C4) -> the weights the kernel
    reads, bf16 (``weight_elems(strategy)``,): per step of ``inner_steps``,
    in order, its tile of ``width`` rows (output columns) of 64 K values,
    K-major, each 128-byte row swizzled (``swizzle_rows``). One gather, on
    the weights' device."""
    if (tuple(kp.shape) != (3, 3, L, NO) or tuple(ku.shape) != (3, 3, C4, C4)
            or tuple(kd.shape) != (3, 3, C4, C4)):
        raise ValueError(f"the kernel takes kp (3, 3, {L}, {NO}), ku and kd (3, 3, {C4}, {C4}); "
                         f"got {tuple(kp.shape)}, {tuple(ku.shape)}, {tuple(kd.shape)}")
    src = torch.cat([kp.reshape(-1), ku.reshape(-1), kd.reshape(-1), kp.new_zeros(1)])
    return src.to(torch.bfloat16).index_select(0, _pack_index(strategy, kp.device))


def inner_step_planned(z, kp, ku, kd, hbo, strategy="dots27"):
    """The kernel's walk in PyTorch: per tile of TILE_ROWS output rows, each
    step's item as the kernel's loads give it (rows outside the plane zero),
    its rows at the step's shift times its packed weight tile, unswizzled,
    into the step's columns; summed in f32, stored as bf16: (B, hbo * WC,
    NO)."""
    z = _batched(z)
    b, _, _, wc, lanes = z.shape
    m, rows = hbo * wc, TILE_ROWS
    packed = pack_inner_weights(kp, ku, kd, strategy)
    z2 = z.reshape(b, 3, -1, lanes)
    out = torch.empty((b, m, NO), dtype=z.dtype, device=z.device)
    cols = {ALL: slice(0, NO), LOW: slice(0, C4), HIGH: slice(C4, NO)}
    for m0 in range(0, m, rows):
        acc = torch.zeros((b, rows, NO), device=z.device)
        for st in inner_steps(strategy):
            if st.new_item:   # the slot's rows: one load of TILE_ROWS + 8
                item = dot_probe.shifted_rows(z2[:, st.plane, :, st.lane0:st.lane0 + C4],
                                              m0 + (1 + st.dh) * wc + st.row, rows + 8)
            tile = swizzle_rows(packed[st.woff:st.woff + st.width * K_TILE].view(st.width, K_TILE))
            acc[..., cols[st.cols]] += item[:, st.shift:st.shift + rows].float() @ tile.float().t()
        out[:, m0:m0 + rows] = acc[:, :min(rows, m - m0)].to(z.dtype)
    return out


def check_inner(z, packed, hbo, strategy):
    """Raise ``ValueError`` or ``TypeError`` on what ``inner_taps`` does not
    take; return z as a batch."""
    z = _batched(z)
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; one of {STRATEGIES}")
    if z.dtype != torch.bfloat16 or packed.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16, not {z.dtype} and {packed.dtype}")
    b, _, hb2, wc, lanes = z.shape
    if hbo < 1 or hb2 != hbo + 2:
        raise ValueError(f"z {tuple(z.shape)} does not hold hbo + 2 = {hbo + 2} rows of WC")
    if lanes != L:
        raise ValueError(f"the kernel is built for the paired layout's L = NO = {L}; got "
                         f"{lanes} lanes")
    if tuple(packed.shape) != (weight_elems(strategy),):
        raise ValueError(f"packed weights {tuple(packed.shape)} are not "
                         f"pack_inner_weights(..., {strategy!r})'s")
    if not (z.is_contiguous() and packed.is_contiguous()):
        raise ValueError("the kernel takes contiguous z and packed weights")
    if z.data_ptr() % 16 or packed.data_ptr() % 16:
        raise ValueError("the kernel's copies read z and the weights from 16-byte boundaries")
    return z


def inner_step_packed(z: torch.Tensor, packed: torch.Tensor, hbo: int,
                      strategy: str = "dots27") -> torch.Tensor:
    """The kernel on CUDA tensors, with the weights packed by
    ``pack_inner_weights(kp, ku, kd, strategy)``: (B, hbo * WC, NO) bf16.
    Counts ``inner_step_packed.launches``."""
    z = check_inner(z, packed, hbo, strategy)
    if z.device.type != "cuda" or packed.device != z.device:
        raise ValueError("z and the packed weights must be on one CUDA device")
    from lintransunet_tpu_torch import kernels

    b, _, _, wc, _ = z.shape
    out = torch.empty((b, hbo * wc, NO), dtype=z.dtype, device=z.device)
    lib = kernels.load("probe_taps")
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = lib.pt_inner_step(z.data_ptr(), packed.data_ptr(), out.data_ptr(), b, hbo, wc,
                                plan_ints(strategy, wc), stream)
    if err != 0:
        raise RuntimeError(f"probe_taps inner-step launch failed: CUDA error {err}")
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
    return inner_step_packed(z, pack_inner_weights(kp, ku, kd, strategy), hbo, strategy)


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


def library_weight(kp, ku, kd):
    """The yardstick's weight, (NO, L, 3, 3, 3) in ``channels_last_3d``: kp
    at depth 1, ku into output columns 0..63 from lanes 64..127 at depth 0,
    kd into columns 64..127 from lanes 0..63 at depth 2."""
    w = kp.new_zeros((NO, L, 3, 3, 3))
    w[:, :, 1] = kp.permute(3, 2, 0, 1)
    w[:C4, C4:, 0] = ku.permute(3, 2, 0, 1)
    w[C4:, :C4, 2] = kd.permute(3, 2, 0, 1)
    return w.contiguous(memory_format=torch.channels_last_3d)


def library_conv(z, w):
    """``F.conv3d`` (cuDNN) on z (B, 3, hbo + 2, WC, L) as its
    ``channels_last_3d`` view (B, L, 3, hbo + 2, WC), no copy, with
    ``library_weight`` and padding (0, 0, 1): (B, NO, 1, hbo, WC). Read as
    (B, hbo * WC, NO) it is the ``dots27`` function at every output column
    but the first and last of each row of WC, where cuDNN pads with zeros
    and the TPU function reads the neighbouring row's end; it runs twice
    dots27's MACs (the zero blocks).
    A yardstick timed beside the kernel; the port never calls it."""
    return F.conv3d(z.permute(0, 4, 1, 2, 3), w, padding=(0, 0, 1))


def main():
    device = common.parse_device(__doc__.splitlines()[0])
    if device.type == "cpu":
        z, kp, ku, kd = inputs(1, 2, device)
        out = inner_step(z, kp, ku, kd, 2)
        print(f"dots27 plain at hbo=2, one window: out {tuple(out.shape)} max |out| "
              f"{out.float().abs().max().item():.3f}")
        return
    z, kp, ku, kd = inputs(BATCH, HBO, device)
    flops, nbytes = costs(BATCH, HBO)
    w_conv = library_weight(kp, ku, kd)

    def conv():
        return library_conv(z, w_conv)

    print(f"{BATCH} windows z (3, {HBO + 2}, {WC}, {L}) bf16 -> ({HBO * WC}, {NO}); FLOPs "
          f"counted as dots27's; beside each, F.conv3d on the same tensor (the same function "
          f"but at the wrap columns, twice the MACs: a yardstick, no library call computes "
          f"the step)", flush=True)
    for strategy in STRATEGIES:
        packed = pack_inner_weights(kp, ku, kd, strategy)

        def run(st=strategy, w=packed):
            return inner_step_packed(z, w, HBO, st)

        ms, conv_ms = common.in_turns([run, conv])
        executed = flops * (4 / 3 if strategy == "kext" else 1)
        print(common.rate_line(strategy, ms, flops, nbytes, executed_flops=executed)
              + f"  F.conv3d {conv_ms:8.4f} ms", flush=True)
        print(common.card_line(run, conv, kernels=True, label="F.conv3d"), flush=True)
    pack_ms = common.cuda_ms(lambda: pack_inner_weights(kp, ku, kd))
    print(f"pack_inner_weights alone (inside every inner_step call): {pack_ms:.4f} ms",
          flush=True)
    centre = z[:, 1].reshape(BATCH, -1, L).contiguous()
    offsets = [(1 + dh) * WC for dh in (-1, 0, 1) for _ in range(3)]
    kp9 = kp.reshape(9, L, NO).contiguous()
    ms = common.cuda_ms(lambda: dot_probe.tap_sum(centre, kp9, offsets, HBO * WC))
    base_flops, base_bytes = dot_probe.tap_sum_costs(centre, kp9, HBO * WC, offsets)
    print(common.rate_line("base9 (centre plane, no dw shift)", ms, base_flops, base_bytes,
                           executed_flops=dot_probe.executed_flops(centre, kp9, HBO * WC, offsets)),
          flush=True)


if __name__ == "__main__":
    main()
