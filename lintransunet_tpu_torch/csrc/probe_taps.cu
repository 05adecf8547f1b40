// Tap-sum probe kernels for Hopper (sm_90a), bound with ctypes.
//
// For each group g of a bf16 operand A and per-tap bf16 weights W (T, K, N):
//
//   out[g, r, n] = sum_t sum_k A[g, r + off[t], k] * W[t, k, n],  0 <= r < m
//
// with rows of A outside [0, rows) read as zero, summed in f32 and stored
// as bf16 (or, `bf16_acc`, each tap's product rounded to bf16 and added to
// a bf16 sum).
//
// Replaces three TPU probe kernels, which compute this function:
//   experiments/pallas_dot_probe.py `bench` (pallas_call at :41): offsets 0;
//   experiments/pallas_rowoffset_probe.py `make_kernel` (pallas_call at :53):
//     9 taps at row offsets 0, k * 576 or k * 577;
//   experiments/pallas_inner_probe.py `make_kernel` (pallas_call at :226):
//     one conv tap step on the paired layout, 9 (dh, dw) taps.
//
// `taps_fold` (#8, #10; `pt_tap_sum`). What bounds it on this card: bytes
// at the probes' shapes once the taps are folded (the function needs one
// product per distinct offset: #10 A ~60 FLOP per compulsory byte, #8 ~95,
// under the H100's ~295 bf16 ridge); operations where every tap counts
// (bf16 accumulation). Its design:
// * Taps folded per distinct offset. Taps at one row offset sum to one
//   product of their summed weight: a lone tap's bf16 weight is used as it
//   is; two or more are summed in f32 and split into hi = bf16(sum) and lo =
//   bf16(sum - hi), two products that hold the result to ~2^-16 of the f32
//   sum of the exact products (a bf16 fold alone would move some outputs by
//   an ulp). bf16 accumulation is not folded: each tap's rounding is the
//   function. The wrapper plans the products (`dot_probe.tap_plan`;
//   `fold_taps_reference` is the fold's plain version).
// * The fold is a launch of its own, `taps_fold_weights`, before the main
//   kernel: it writes every column tile's folded weights once, K-major and
//   swizzled as the main kernel keeps them, into a scratch. Folded in each
//   block's prologue instead, every one of 132 blocks read all the raw taps
//   from L2 (147 KB at #10 A), the longest part of a block (PERF.md).
// * `taps_fold` runs under programmatic dependent launch: it stages its
//   first A items while the fold runs, then one thread waits for the fold
//   (`griddepcontrol.wait`) and bulk-copies the block's folded tiles into
//   shared memory in one copy (resident, the largest column tile where they
//   fit). Where they fit at no column tile, each item's tiles come by a bulk
//   copy through a ring of weight slots two longer than the A ring: at step
//   s the copy for step s + ahead (ahead = A slots - 1) refills the slot
//   that step s - 3 read, whose `wgmma`s every warpgroup has retired (its
//   `wgmma_wait<1>` at step s - 1) before the barrier that the copy follows.
//   One slot fewer would refill step s - 2's slot, which step s - 1's wait
//   leaves in flight.
// * Shifted tiles, not a window: a tile is 128 output rows (two warpgroups
//   of 64) and NT <= 128 columns; per distinct offset and 64-wide K chunk
//   the block stages rows [m0 + off, m0 + off + 128) into a tile swizzled by
//   `ltu::swz`, by one thread's tensor-map loads (TMA, the 128-byte swizzle,
//   zero fill outside [0, rows) and past K), each slot completing on an
//   mbarrier, so that no thread issues or waits for copies of its own (with
//   16-byte `cp.async` by every thread, staging alone took ~75% of #10 A's
//   time and #8 C ran 35% longer; PERF.md). A row is 2 K bytes, so an offset
//   of 577 rows is as aligned as one of 576, and a row of A is read once per
//   distinct offset (again from L2), not (128 + span) / 128 times. A ring of
//   2-4 such items runs on across tiles, so the next tile's loads overlap
//   this tile's epilogue.
// * Persistent grid: one block per SM, each on one column tile, walking row
//   tiles in order within a group, so that the neighbouring tiles' shifted
//   reads hit L2 (a #8 group spans 2.9 MB).
// * Products: `wgmma` m64nNTk16 (NT 16, 32, 64 or 128), A from registers
//   (each warp's `ldmatrix` fragments of the shifted tile), B by descriptor
//   from the K-major weight tile, f32 accumulators in registers. An item's
//   64 K of every product is one commit group, its `wgmma`s round-robin over
//   up to 4 independent accumulators (one chain of dependent 64 x 64 x 16
//   products runs at their latency, not their rate), waited for only when
//   its fragment registers are loaded again two items later
//   (`wgmma_wait<1>`). A fresh sum starts by the `wgmma` scale-d predicate,
//   so no other instruction writes the accumulators.
// * Epilogue: the accumulators summed, rounded to bf16 through the spent
//   ring slot, and stored as 16-byte row segments.
// * bf16 accumulation: where the whole of K fits in one item, A is staged
//   once for each run of consecutive taps at one offset and each tap's
//   product goes into a fresh accumulator, rounded to bf16 and added into
//   the running bf16 sum, kept in shared memory (in registers it makes ptxas
//   serialise the `wgmma`s); otherwise each (tap, K chunk) is an item of its
//   own. The taps keep their order, so the sum rounds in the
//   function's order.
//
// `inner_taps` (#11; `pt_inner_step`): one conv tap step on the level-0
// paired layout, for windows b of z (B, 3, hbo + 2, WC, 128) seen as planes
// z2[b, 0..2] of (hbo + 2) WC rows,
//
//   out[b, r] = sum_{dh, dw} z2[b, 1, r + s] @ kp[dh, dw]
//               + [z2[b, 0, r + s, 64:] @ ku[dh, dw] | z2[b, 2, r + s, :64] @ kd[dh, dw]]
//
// with s = (1 + dh) WC + dw and rows outside a plane zero. What bounds it
// on this card: operations, near the ridge (at the probe's shape 46 GFLOP
// against ~121 MB of compulsory bytes), and L2 traffic: its weights (442 KB
// of non-zero blocks) do not fit in shared memory, so they stream, once per
// tile. Its design:
// * Items are slabs: per kernel row dh and 64-lane chunk (the centre plane's
//   two halves, the previous plane's upper half, the next plane's lower
//   half: the paired layout's splice is only a tensor-map coordinate) the
//   rows [m0 + (1 + dh) WC - 1, ...) of a tile, by one thread's tensor-map
//   loads (TMA, 128-byte swizzle, zero fill outside the plane: `_dot_pad`'s
//   clipping) into a ring slot that completes on an mbarrier. The three dw
//   taps read the slab at row shifts 0, 1 and 2 by `ldmatrix` into the
//   `wgmma` A fragments, so no tap's tile is staged alone. `bext_s` (the
//   im2col counterpart) stages each tap's rows aligned by loads of their own
//   instead: three times the loads, no shifted read.
// * The weights are packed once per call by the wrapper
//   (`inner_probe.pack_inner_weights`) in the order the kernel reads them:
//   per step (dh, chunk, dw) one K-major tile of 64 K, swizzled as
//   `ltu::swz`, 128 columns for a centre chunk (every chunk of `kext`) and
//   64 for a neighbour chunk's non-zero block. They come through a ring of
//   bulk copies three slots longer than its lookahead: at step s the copy
//   for step s + ahead refills step s - 3's slot, whose `wgmma`s every
//   warpgroup has retired (its `wgmma_wait<1>` at step s - 1) before the
//   barrier that the copy follows; a slot fewer would refill step s - 2's,
//   which step s - 1's wait leaves in flight.
// * A tile is 192 output rows on three warpgroups, each its 64 rows, so every
//   weight tile copied serves 192 rows (128-row tiles took 16% longer; four
//   warpgroups, 256 rows, took as long for `dots27`, but 512 threads have
//   128 registers each and ptxas spilled; PERF.md):
//   `wgmma` with A from registers, m64n128k16 into one accumulator for
//   `kext`; for `dots27` and `bext_s` m64n64k16 only, a centre step two a
//   k16 step and a neighbour step one, into the half of the accumulator it
//   adds to (its first or last 32 registers; mixing the two shapes on one
//   accumulator made ptxas serialise every `wgmma`). A step's `wgmma`s are one commit group, waited for one
//   step later (`wgmma_wait<1>`), so one step's products run while the next
//   step's barrier, waits and fragment loads go on.
// * Persistent grid: one block per SM walks its tiles in order, the blocks
//   side by side on neighbouring tiles, so that slabs that tiles share hit
//   L2; the A ring (3 items) runs on across tiles. A tile's output goes
//   through the A slot its last step read, as 16-byte row stores.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;

// ---------------------------------------------------------------------------
// taps_fold: the tap sum with taps folded per distinct offset (#8, #10)
// ---------------------------------------------------------------------------

constexpr int kRows = 128;                   // output rows per tile, 16 a warp
constexpr int kKT = 64;                      // K per A sub-tile and weight tile
constexpr int kATile = kRows * kKT;          // elements of one A sub-tile (16 KB)
constexpr int kMaxD = 32;                    // distinct offsets
constexpr int kMaxP = 32;                    // products (hi and lo count two)
constexpr int kPlanHeader = 20;
constexpr int kMaxDevices = 64;
// Shared memory: the A ring from 0, then (bf16 accumulation) the running
// sums, the weights (resident, or a ring of slots) below kTapSmem, the
// weights' mbarriers at kTapSmem.
constexpr int kTapSmem = kSmemLimit - 1024;
constexpr int kABar = 16;  // the A slots' barriers, after the weights' (at most 6)

// How a tile's items run: folded f32 sum (an item is one distinct offset at
// one K chunk); bf16 accumulation with the whole of K in one item (an item
// is one distinct offset, all its taps); bf16 accumulation by (tap, chunk).
enum TapMode { kFold = 0, kWhole = 1, kSplit = 2 };
// What a product's weight is: its one tap's as it is, or the hi or lo part
// of its taps' f32 sum.
enum Part { kAsIs = 0, kHi = 1, kLo = 2 };

struct TapArgs {
  const bf16* x;       // (groups, rows, k) contiguous
  const bf16* w;       // (taps, k, n) contiguous
  bf16* out;           // (groups, m, n) contiguous
  int groups, rows, m, k, n;
  int nt;              // columns per tile
  int nkc;             // 64-wide K chunks (K padded with zeros)
  int col_tiles, row_tiles;
  int mode, streamed, slots, nsub, items;
  int nd, np, ng;
  int w_offset;        // bytes from the start of shared memory to the weights
  int sum_offset;      // bf16 accumulation: bytes to the running sums (after the ring)
  int d_off[kMaxD];    // distinct offset d's rows, and its products
  int d_p0[kMaxD], d_np[kMaxD];
  int p_d[kMaxP], p_part[kMaxP], p_t0[kMaxP], p_nt[kMaxP];  // taps tap_idx[t0 .. t0 + nt)
  int tap_idx[kMaxP];
  int g_p[kMaxP];      // fold group g's first product (a lone tap, hi, or one tap)
};

// A walk over a block's steps: the step's item (its index i in the tile,
// distinct offset d, K chunk kc, products [p0, p0 + np)) and its tile (the
// block's j-th: group g, first output row m0; column tile blockIdx.x %
// col_tiles throughout), one step at a time, dividing only at a tile's
// start.
struct Cursor {
  int i, j, g, m0, d, kc, p0, np;

  __device__ __forceinline__ void tile(const TapArgs& a) {
    const int rt = blockIdx.x / a.col_tiles + j * (gridDim.x / a.col_tiles);
    g = rt / a.row_tiles;
    m0 = (rt % a.row_tiles) * kRows;
  }
  __device__ __forceinline__ void products(const TapArgs& a) {
    if (a.mode == kSplit) {
      np = 1;
      d = a.p_d[p0];
    } else {
      p0 = a.d_p0[d];
      np = a.d_np[d];
    }
  }
  __device__ __forceinline__ void start(const TapArgs& a) {
    i = j = d = kc = p0 = 0;
    tile(a);
    products(a);
  }
  __device__ __forceinline__ void next(const TapArgs& a) {
    if (++i == a.items) {
      i = d = kc = p0 = 0;
      ++j;
      tile(a);
    } else if (a.mode == kFold) {  // for each chunk, each distinct offset
      if (++d == a.nd) {
        d = 0;
        ++kc;
      }
    } else if (a.mode == kWhole) {  // each run of taps, all of K
      ++d;
    } else if (++kc == a.nkc) {  // each tap, each chunk
      kc = 0;
      ++p0;
    }
    products(a);
  }
  // bf16 accumulation by (tap, chunk): the tap's last chunk
  __device__ __forceinline__ bool tap_last(const TapArgs& a) const { return kc == a.nkc - 1; }
};

// One tensor-map load (TMA) of the box at coordinates (x, y, z) of `map`
// into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            unsigned long long* bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(ltu::smem_addr(dst)), "l"(map), "r"(ltu::smem_addr(bar)), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// The cursor's item into ring slot `slot`, by one thread: rows [m0 + off, m0 +
// off + 128) of its K chunks, one tensor-map load (TMA) a 64-wide sub-tile,
// all completing on `bar`. The map (x as (groups, rows, k), boxes of 1 x 128
// x 64, the 128-byte swizzle, which is `ltu::swz`'s) zero-fills rows outside
// [0, rows) and K past its end, and counts those bytes too.
__device__ __forceinline__ void stage_item(bf16* slot, const TapArgs& a, const Cursor& c,
                                           const CUtensorMap* xmap, unsigned long long* bar) {
  ltu::mbar_expect_tx(bar, static_cast<unsigned>(a.nsub * kATile * 2));
  for (int sub = 0; sub < a.nsub; ++sub) {
    tma_load_3d(slot + sub * kATile, xmap, bar, (c.kc + sub) * kKT, c.m0 + a.d_off[c.d], c.g);
  }
}

// An 8 x 8 block over lanes l = lane % 8 of each 8 lanes, v[c] = M[l][c] on
// entry, v[r] = M[r][l] on return: three rounds swapping the off-diagonal
// s x s blocks between lanes l and l ^ s.
__device__ __forceinline__ void transpose8(float (&v)[8], int l) {
#pragma unroll
  for (int s = 4; s >= 1; s >>= 1) {
    const bool upper = l & s;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c & s) continue;
      const float got = __shfl_xor_sync(ltu::kFullMask, upper ? v[c] : v[c | s], s);
      if (upper) {
        v[c] = got;
      } else {
        v[c | s] = got;
      }
    }
  }
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

// Elements of one weight tile: NT rows (output columns) of 64 K values.
template <int NT>
constexpr int kTileElems = NT * kKT;

// The fold, one launch before taps_fold: every column tile's folded weights
// into `folded`, tile (column tile ct, K chunk kc, product p) at folded +
// ((ct * nkc + kc) * np + p) * NT * 64, each NT rows of 64 K values
// (K-major, 128-byte rows swizzled by `ltu::swz`), as taps_fold keeps them
// in shared memory; zeros past K. A thread sums row k of 8 columns of one
// fold group (a lone tap's product, a hi and lo pair, or one tap under bf16
// accumulation) over its taps in f32, in tap order, 8 loads in flight; the
// 8 lanes of rows k8 * 8 .. + 7 transpose their 8 x 8 block by shuffles and
// each stores one 16-byte K-major row segment (and its lo partner's).
template <int NT>
__global__ void __launch_bounds__(kThreads) taps_fold_weights(const TapArgs a, bf16* folded) {
  pdl_trigger();  // taps_fold may start staging A; it waits for this grid before the weights
  const int u = blockIdx.x * kThreads + threadIdx.x;
  const int units = a.col_tiles * a.ng * a.nkc * kKT * (NT / 8);
  const bool live = u < units;  // whole warps: units is a multiple of 128
  int r = live ? u : 0;
  const int l = r & 7;
  r >>= 3;
  const int n8 = r % (NT / 8);
  r /= NT / 8;
  const int k8 = r % 8;
  r /= 8;
  const int kc = r % a.nkc;
  r /= a.nkc;
  const int g = r % a.ng, ct = r / a.ng, p = a.g_p[g];
  const int k = kc * kKT + k8 * 8 + l;
  float sum[8] = {};
  if (live && k < a.k) {
    const bf16* src = a.w + static_cast<long long>(k) * a.n + ct * NT + n8 * 8;
    const int* taps = a.tap_idx + a.p_t0[p];
#pragma unroll 8
    for (int q = 0; q < a.p_nt[p]; ++q) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(taps[q]) * a.k * a.n));
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int col = 0; col < 8; ++col) sum[col] += __bfloat162float(e[col]);
    }
  }
  transpose8(sum, l);  // sum[j]: row k8 * 8 + j, column n8 * 8 + l
  if (!live) return;
  uint4 vh, vl;
  unsigned* h = reinterpret_cast<unsigned*>(&vh);
  unsigned* lw = reinterpret_cast<unsigned*>(&vl);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = ltu::pack_bf16x2(sum[2 * j], sum[2 * j + 1]);
    lw[j] = ltu::pack_bf16x2(sum[2 * j] - ltu::round_to<bf16>(sum[2 * j]),
                             sum[2 * j + 1] - ltu::round_to<bf16>(sum[2 * j + 1]));
  }
  bf16* hi = folded + (static_cast<long long>(ct * a.nkc + kc) * a.np + p) * kTileElems<NT>;
  const int e = ltu::swz(n8 * 8 + l, k8, 8);
  *reinterpret_cast<uint4*>(hi + e) = vh;
  if (a.p_part[p] == kHi) *reinterpret_cast<uint4*>(hi + kTileElems<NT> + e) = vl;  // p + 1
}

// Keeps the registers of a set of A fragments live, unchanged, up to this
// point: a `wgmma` may still read them after its instruction has issued.
__device__ __forceinline__ void keep(unsigned (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3]));
  }
}

// acc (+)= the A sub-tile's 128 rows times weight tiles b0 (and b1 when np
// is 2; K-major, NT x 64) over 64 K, by `wgmma` m64nNTk16: each warpgroup
// its 64 rows, each warp's 16 as its `ldmatrix` fragments, all four k16
// steps' fragments (set SET) loaded first, and the 4 np `wgmma`s one commit
// group. The `wgmma`s go round-robin to NA independent accumulators (their
// sum is the result): one accumulator would make them a chain, each
// waiting for the last, at a 64 x 64 x 16 product's latency rather than its
// rate. `fresh` starts a new sum: each accumulator's first `wgmma` ignores
// it (scale-d 0), so no other instruction writes the accumulators, which
// would make ptxas serialise the `wgmma`s. Calls alternate the two fragment
// sets; a call waits only for the call before the last (`wgmma_wait<1>`),
// the one that read its set, so one call's products run while the next
// call's barrier, copies and fragment loads go on.
template <int NT, int NA, int SET>
__device__ __forceinline__ void product(float (&acc)[NA][NT / 2], unsigned (&af)[2][4][4],
                                        const bf16* a_tile, const bf16* b0, const bf16* b1,
                                        int np, bool fresh, int warp, int lane) {
  ltu::wgmma_wait<1>();
  keep(af[SET]);
#pragma unroll
  for (int ks = 0; ks < kKT / 16; ++ks) {
    ltu::ldsm_x4(af[SET][ks],
                 a_tile + ltu::swz(warp * 16 + (lane & 15), ks * 2 + (lane >> 4), 8));
  }
#pragma unroll
  for (int q = 0; q < NA; ++q) ltu::wgmma_fence_operand(acc[q]);
  ltu::wgmma_fence();
  const unsigned long long d0 = ltu::wgmma_desc_kmajor(b0, 128);
  // the j-th `wgmma` of the call: accumulator j % NA, fresh for the first NA
  auto mma = [&](int j, unsigned long long desc, int ks) {
    ltu::wgmma_m64k16<NT>(acc[j % NA], af[SET][ks], desc + 2 * ks, !(fresh && j < NA));
  };
  if (np > 1) {
    const unsigned long long d1 = ltu::wgmma_desc_kmajor(b1, 128);
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks) mma(ks, d0, ks);
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks) mma(kKT / 16 + ks, d1, ks);
    ltu::wgmma_commit();
  } else {
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks) mma(ks, d0, ks);
    ltu::wgmma_commit();
  }
#pragma unroll
  for (int q = 0; q < NA; ++q) ltu::wgmma_fence_operand(acc[q]);
}

// Waits for every `wgmma` of this warpgroup; then tot = the accumulators' sum.
template <int NA, int R>
__device__ __forceinline__ void wait_sum(float (&acc)[NA][R], float (&tot)[R]) {
  ltu::wgmma_wait<0>();
#pragma unroll
  for (int q = 0; q < NA; ++q) ltu::wgmma_fence_operand(acc[q]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    tot[i] = acc[0][i];
#pragma unroll
    for (int q = 1; q < NA; ++q) tot[i] += acc[q][i];
  }
}

// The tile (each warp's 16 rows of v), rounded to bf16, through `stage` (a
// ring slot of at least ROWS rows of 64 columns, swizzled) into 16-byte
// stores of whole row segments, 64 columns at a time: row m0 + r of the
// output at og + (m0 + r) * ld; rows past m are not stored. Every thread of
// the block (2 ROWS threads, each warp 16 rows) calls it: the block's reads
// of the slot come first.
template <int NT, int ROWS>
__device__ __forceinline__ void store_tile(bf16* og, int ld, int m, const float (&v)[NT / 2],
                                           bf16* stage, int m0, int tid) {
  constexpr int kCols = NT < kKT ? NT : kKT, kCpr = kCols / 8;
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int cb = 0; cb < NT; cb += kCols) {
    __syncthreads();  // the slot's (or the last columns') readers are done
#pragma unroll
    for (int t = 0; t < kCpr; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + (lane >> 2) + 8 * h, j = cb / 8 + t;
        *reinterpret_cast<unsigned*>(stage + ltu::swz(r, t, kCpr) + 2 * (lane & 3)) =
            ltu::pack_bf16x2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
      }
    }
    __syncthreads();
    for (int i = tid; i < ROWS * kCpr; i += 2 * ROWS) {
      const int r = i / kCpr, c = i % kCpr;
      if (m0 + r >= m) continue;
      *reinterpret_cast<uint4*>(og + static_cast<long long>(m0 + r) * ld + cb + c * 8) =
          *reinterpret_cast<const uint4*>(stage + ltu::swz(r, c, kCpr));
    }
  }
  ltu::fence_proxy_async();  // the slot's next fill, a tensor-map load, comes after these
}

// sum = bf16(sum + bf16(t)), the sum of two bf16 values rounded (first:
// sum = bf16(t)). The thread's R running sums live in shared memory as R / 2
// bf16 pairs at sum[j * kThreads + tid]: carried in registers from `wgmma`
// to `wgmma`, ptxas serialises every `wgmma` of the kernel (its note C7513).
template <int R>
__device__ __forceinline__ void round_add(unsigned* sum, const float (&t)[R], bool first,
                                          int tid) {
#pragma unroll
  for (int j = 0; j < R / 2; ++j) {
    float lo = 0.f, hi = 0.f;
    if (!first) {
      const unsigned v = sum[j * kThreads + tid];
      lo = __bfloat162float(reinterpret_cast<const __nv_bfloat162*>(&v)->x);
      hi = __bfloat162float(reinterpret_cast<const __nv_bfloat162*>(&v)->y);
    }
    sum[j * kThreads + tid] = ltu::pack_bf16x2(lo + ltu::round_to<bf16>(t[2 * j]),
                                               hi + ltu::round_to<bf16>(t[2 * j + 1]));
  }
}

// The thread's running sums (round_add) as floats.
template <int R>
__device__ __forceinline__ void load_sum(float (&t)[R], const unsigned* sum, int tid) {
#pragma unroll
  for (int j = 0; j < R / 2; ++j) {
    const unsigned v = sum[j * kThreads + tid];
    t[2 * j] = __bfloat162float(reinterpret_cast<const __nv_bfloat162*>(&v)->x);
    t[2 * j + 1] = __bfloat162float(reinterpret_cast<const __nv_bfloat162*>(&v)->y);
  }
}

// Independent accumulators of `product`: as many as keep them within 128
// registers a thread (64 where a bf16 sum of the same size lives beside
// them), at most 4 (an item's 4 k16 steps).
template <int NT, bool kBf16Acc>
constexpr int kAccumulators = (kBf16Acc ? 128 : 256) / NT < 4 ? (kBf16Acc ? 128 : 256) / NT : 4;

template <int NT, bool kBf16Acc, bool kStreamed>
__global__ void __launch_bounds__(kThreads, 1)
    taps_fold(const TapArgs a, const bf16* folded, const __grid_constant__ CUtensorMap xmap) {
  constexpr int NA = kAccumulators<NT, kBf16Acc>;
  constexpr int kTile = kTileElems<NT>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot_elems = a.nsub * kATile;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* wts = reinterpret_cast<bf16*>(smem + a.w_offset);
  // the weights' barriers: one (resident), or one per weight slot (streamed);
  // then one per A slot
  auto* wbar = reinterpret_cast<unsigned long long*>(smem + kTapSmem);
  auto* abar = wbar + kABar;
  // streamed: the slot step s + ahead fills is step s - 3's (retired; see the note above)
  const int wslots = a.slots + 2;
  const int ct = blockIdx.x % a.col_tiles, n0 = ct * NT;
  const bf16* wsrc = folded + static_cast<long long>(ct) * a.nkc * a.np * kTile;
  const int per_col = gridDim.x / a.col_tiles;
  const int tiles = (a.groups * a.row_tiles - static_cast<int>(blockIdx.x) / a.col_tiles +
                     per_col - 1) / per_col;
  const int steps = tiles * a.items;
  const int ahead = a.slots - 1;
  if (tid == 0) {
    for (int i = 0; i < (kStreamed ? wslots : 1); ++i) ltu::mbar_init(wbar + i, 1);
    for (int i = 0; i < a.slots; ++i) ltu::mbar_init(abar + i, 1);
    ltu::fence_mbar_init();
  }
  __syncthreads();

  Cursor st, cu;  // the next step to stage, the step to run
  st.start(a);
  cu.start(a);
  // step s's weights (streamed): its products' tiles at its K chunk, one copy
  auto stage_weights = [&](int s) {
    ltu::fence_proxy_async();  // the block's earlier reads come before the copy
    const unsigned bytes = static_cast<unsigned>(st.np * kTile * 2);
    ltu::mbar_expect_tx(wbar + s % wslots, bytes);
    ltu::bulk_copy(wts + (s % wslots) * 2 * kTile, wsrc + (st.kc * a.np + st.p0) * kTile, bytes,
                   wbar + s % wslots);
  };
  for (int s = 0; s < ahead; ++s) {  // A does not wait for the fold
    if (tid == 0 && s < steps) stage_item(ring + s * slot_elems, a, st, &xmap, abar + s);
    if (kStreamed && tid == 0 && s < steps) {
      if (s == 0) pdl_wait();
      stage_weights(s);
    }
    st.next(a);
  }
  if (!kStreamed && tid == 0) {  // the block's folded weights, one copy once the fold is done
    pdl_wait();
    const unsigned bytes = static_cast<unsigned>(a.nkc * a.np * kTile * 2);
    ltu::mbar_expect_tx(wbar, bytes);
    ltu::bulk_copy(wts, wsrc, bytes, wbar);
  }
  if (!kStreamed) ltu::mbar_wait(wbar, 0);

  float acc[NA][NT / 2], tot[NT / 2];
  auto* sum = reinterpret_cast<unsigned*>(smem + a.sum_offset);  // bf16 accumulation
  unsigned af[2][4][4] = {};
  // step s: the next copies issued, its item's A landed, its products; item
  // s reads fragment set s % 2 (SET), so the loop runs steps in pairs
  auto step = [&](int s, auto set) {
    constexpr int SET = decltype(set)::value;
    __syncthreads();  // the block is done with step s - 1's slot, which step s + ahead fills
    if (tid == 0 && s + ahead < steps) {
      const int slot = (s + ahead) % a.slots;
      stage_item(ring + slot * slot_elems, a, st, &xmap, abar + slot);
      if (kStreamed) stage_weights(s + ahead);
    }
    st.next(a);
    ltu::mbar_wait(abar + s % a.slots, (s / a.slots) & 1);

    const bf16* a_tile = ring + (s % a.slots) * slot_elems;
    if constexpr (kStreamed) ltu::mbar_wait(wbar + s % wslots, (s / wslots) & 1);
    // weight tile of product p at K chunk c
    auto wtile = [&](int p, int c) {
      return kStreamed ? wts + ((s % wslots) * 2 + p - cu.p0) * kTile
                       : wts + (c * a.np + p) * kTile;
    };
    if constexpr (kBf16Acc) {
      if (a.mode == kWhole) {  // every tap of this run over all of K
        for (int p = cu.p0; p < cu.p0 + cu.np; ++p) {
          for (int c = 0; c < a.nsub; c += 2) {
            product<NT, NA, 0>(acc, af, a_tile + c * kATile, wtile(p, c), nullptr, 1, c == 0,
                               warp, lane);
            if (c + 1 < a.nsub) {
              product<NT, NA, 1>(acc, af, a_tile + (c + 1) * kATile, wtile(p, c + 1), nullptr,
                                 1, false, warp, lane);
            }
          }
          wait_sum(acc, tot);
          round_add(sum, tot, cu.i == 0 && p == cu.p0, tid);
        }
      } else {
        product<NT, NA, SET>(acc, af, a_tile, wtile(cu.p0, cu.kc), nullptr, 1, cu.kc == 0, warp,
                             lane);
        if (cu.tap_last(a)) {
          wait_sum(acc, tot);
          round_add(sum, tot, cu.p0 == 0, tid);  // the tile's first tap
        }
      }
    } else {
      product<NT, NA, SET>(acc, af, a_tile, wtile(cu.p0, cu.kc), wtile(cu.p0 + 1, cu.kc), cu.np,
                           cu.i == 0, warp, lane);
    }
    if (cu.i == a.items - 1) {  // the slot read this step is spent: the stores' stage
      bf16* stage = ring + (s % a.slots) * slot_elems;
      bf16* out_g = a.out + static_cast<long long>(cu.g) * a.m * a.n + n0;
      if constexpr (kBf16Acc) {
        load_sum(tot, sum, tid);
        store_tile<NT, kRows>(out_g, a.n, a.m, tot, stage, cu.m0, tid);
      } else {
        wait_sum(acc, tot);
        store_tile<NT, kRows>(out_g, a.n, a.m, tot, stage, cu.m0, tid);
      }
    }
    cu.next(a);
  };
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(s, std::integral_constant<int, 0>{});
    step(s + 1, std::integral_constant<int, 1>{});
  }
  if (s < steps) step(s, std::integral_constant<int, 0>{});
}

template <int NT, bool kBf16Acc, bool kStreamed>
int launch_fold(const TapArgs& a, bf16* folded, const CUtensorMap& xmap, cudaStream_t stream) {
  // per instantiation and device, once: the shared-memory attribute and the
  // SM count (a block takes all of an SM's shared memory: one block an SM)
  static int sms[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(taps_fold<NT, kBf16Acc, kStreamed>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int units = a.col_tiles * a.ng * a.nkc * kKT * (NT / 8);
  taps_fold_weights<NT><<<(units + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a, folded);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const long long row_tiles = static_cast<long long>(a.groups) * a.row_tiles;
  long long per_col = sms[device] / a.col_tiles;
  per_col = per_col < 1 ? 1 : (per_col > row_tiles ? row_tiles : per_col);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(per_col * a.col_tiles));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemLimit;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, taps_fold<NT, kBf16Acc, kStreamed>, a,
                           static_cast<const bf16*>(folded), xmap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int dispatch_fold(const TapArgs& a, bool bf16_acc, bf16* folded, const CUtensorMap& xmap,
                  cudaStream_t s) {
  if (a.streamed) {
    return bf16_acc ? launch_fold<NT, true, true>(a, folded, xmap, s)
                    : launch_fold<NT, false, true>(a, folded, xmap, s);
  }
  return bf16_acc ? launch_fold<NT, true, false>(a, folded, xmap, s)
                  : launch_fold<NT, false, false>(a, folded, xmap, s);
}

// x (groups, rows, k) bf16 as a tensor map of 1 x box_rows x 64 boxes with
// the 128-byte swizzle, zeros outside (`stage_item`, `inner_taps`); the
// driver's encoder is found once through the runtime, so nothing links the
// driver library.
int x_tensor_map(CUtensorMap* map, const bf16* x, int groups, int rows, int k, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess) return static_cast<int>(cudaErrorNotSupported);
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k) * 2,
                                 static_cast<cuuint64_t>(rows) * k * 2};
  const cuuint32_t box[3] = {kKT, static_cast<cuuint32_t>(box_rows), 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}



// ---------------------------------------------------------------------------
// inner_taps: one conv tap step on the paired layout (#11)
// ---------------------------------------------------------------------------

constexpr int kInLanes = 128;             // a plane row's lanes, and the output's columns
constexpr int kInChunk = 64;              // lanes of one A item: 128-byte rows
constexpr int kInRows = 192;              // output rows a tile: 3 warpgroups of 64
constexpr int kInThreads = 2 * kInRows;   // each warp 16 rows
constexpr int kInWTile = kInLanes * kKT;  // elements of a 128-column weight tile (16 KB)
constexpr int kMaxSteps = 36;             // steps of a tile: 3 dh x 4 chunks x 3 dw
constexpr int kInPlanHeader = 3;
// An A slot: one slab load (a box of 1 x 200 x 64) of the 194 rows that the
// three dw shifts read, rounded up to 8; room for the tile's output stage
// (192 rows of 64 columns). The weights' ring takes the rest of shared
// memory below the barriers.
constexpr int kInBox = kInRows + 8;
constexpr int kInASlot = kInBox * kInChunk;  // elements
constexpr int kInASlots = 3;
constexpr int kInWSlots = (kTapSmem - kInASlots * kInASlot * 2) / (kInWTile * 2);
static_assert(kInWSlots >= 5 && kInASlots + kInWSlots <= 128, "rings and their barriers fit");

// A tile's plan (`inner_probe.plan_ints`): per step, `flags` (bit 0: the
// step starts a new A item; bits 1-2: the item's plane of the window, 0..2;
// bit 3: its lanes 64..127, else 0..63; bits 4-5: the step's output
// columns, 0 all 128, 1 0..63, 2 64..127; bits 6-7: its A rows' shift into
// the item), an item's first row from the tile's first output row, and the
// step's weight tile (element offset in w); per item, its first step.
struct InnerArgs {
  const bf16* w;   // the packed weights
  bf16* out;       // (batch, m, 128)
  int batch, m, row_tiles;
  int steps, items;  // a tile's
  int flags[kMaxSteps], row[kMaxSteps], woff[kMaxSteps], item_step[kMaxSteps];
};

// Step products (one commit group a warpgroup) into v, an m64n128
// accumulator (columns 8t .. 8t + 7 in v[4t .. 4t + 3]): kHalves (`dots27`,
// `bext_s`, whose neighbour steps add to one half of the columns) runs every
// product as m64n64k16 into v[0..31] (columns 0..63) or v[32..63], a
// 128-column step as two; else (`kext`) one m64n128k16 a k16 step. One
// `wgmma` shape a kernel: m64n64k16 into either half of v beside m64n128k16
// into all of it made ptxas serialise every `wgmma` (its note C7511), which
// cost 5% (PERF.md).
template <bool kHalves>
struct InnerAcc {
  float v[64];
  __device__ __forceinline__ void fence() { ltu::wgmma_fence_operand(v); }
  // the step's four k16 products; `fresh`: the tile's first, which starts the sums
  __device__ __forceinline__ void step(const unsigned (&af)[4][4], unsigned long long desc,
                                       int cols, bool fresh) {
    if constexpr (kHalves) {
      if (cols != 2) {
#pragma unroll
        for (int ks = 0; ks < kKT / 16; ++ks) {
          ltu::wgmma_m64n64k16<0>(v, af[ks], desc + 2 * ks, !(fresh && ks == 0));
        }
      }
      if (cols != 1) {  // a 128-column tile's second half starts 64 rows on
        const unsigned long long upper = cols == 0 ? desc + ((64 * 128) >> 4) : desc;
#pragma unroll
        for (int ks = 0; ks < kKT / 16; ++ks) {
          ltu::wgmma_m64n64k16<32>(v, af[ks], upper + 2 * ks, !(fresh && ks == 0));
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kKT / 16; ++ks) {
        ltu::wgmma_m64n128k16(v, af[ks], desc + 2 * ks, !(fresh && ks == 0));
      }
    }
  }
};

template <bool kHalves>
__global__ void __launch_bounds__(kInThreads, 1)
    inner_taps(const InnerArgs a, const __grid_constant__ CUtensorMap zmap) {
  constexpr int kWAhead = kInWSlots - 3;  // the copy refills step s - 3's slot (above)
  constexpr int kAAhead = kInASlots - 1;  // the load refills item q - 1's slot
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* aring = reinterpret_cast<bf16*>(smem);
  bf16* wring = aring + kInASlots * kInASlot;
  auto* wbar = reinterpret_cast<unsigned long long*>(smem + kTapSmem);
  auto* abar = wbar + kInWSlots;
  const int grid = static_cast<int>(gridDim.x), block = static_cast<int>(blockIdx.x);
  const int tiles = (a.batch * a.row_tiles - block + grid - 1) / grid;
  const int steps = tiles * a.steps, items = tiles * a.items;
  if (tid == 0) {
    for (int i = 0; i < kInWSlots; ++i) ltu::mbar_init(wbar + i, 1);
    for (int i = 0; i < kInASlots; ++i) ltu::mbar_init(abar + i, 1);
    ltu::fence_mbar_init();
  }
  __syncthreads();

  // the block's j-th tile: window b, first output row m0
  auto tile = [&](int j, int& b, int& m0) {
    const int t = block + j * grid;
    b = t / a.row_tiles;
    m0 = (t % a.row_tiles) * kInRows;
  };
  // step s's weight tile into its slot, one bulk copy (thread 0)
  auto stage_w = [&](int s) {
    const int i = s % a.steps;
    const unsigned bytes = ((a.flags[i] >> 4 & 3) ? kInWTile / 2 : kInWTile) * 2;
    unsigned long long* bar = wbar + s % kInWSlots;
    ltu::mbar_expect_tx(bar, bytes);
    ltu::bulk_copy(wring + (s % kInWSlots) * kInWTile, a.w + a.woff[i], bytes, bar);
  };
  // item q's slab into its slot, one tensor-map load (thread 0)
  auto stage_a = [&](int q) {
    const int i = a.item_step[q % a.items], f = a.flags[i];
    int b, m0;
    tile(q / a.items, b, m0);
    bf16* slot = aring + (q % kInASlots) * kInASlot;
    unsigned long long* bar = abar + q % kInASlots;
    ltu::mbar_expect_tx(bar, static_cast<unsigned>(kInASlot * 2));
    tma_load_3d(slot, &zmap, bar, (f >> 3 & 1) * kInChunk, m0 + a.row[i], 3 * b + (f >> 1 & 3));
  };
  if (tid == 0) {
    for (int s = 0; s < kWAhead && s < steps; ++s) stage_w(s);
    for (int q = 0; q < kAAhead && q < items; ++q) stage_a(q);
  }

  InnerAcc<kHalves> acc;
  unsigned af[2][4][4] = {};
  int q = -1;  // the item that step s reads
  // step s: the next copies issued, its item and weights landed, its
  // products; step s loads fragment set s % 2 (SET), so the loop runs steps
  // in pairs
  auto step = [&](int s, auto set) {
    constexpr int SET = decltype(set)::value;
    const int i = s % a.steps, f = a.flags[i];
    const bool new_item = f & 1;
    __syncthreads();  // step s - 1's A reads are done, step s - 3's weights retired
    if (new_item) ++q;
    if (tid == 0) {
      if (s + kWAhead < steps) stage_w(s + kWAhead);
      if (new_item && q + kAAhead < items) stage_a(q + kAAhead);
    }
    bf16* slab = aring + (q % kInASlots) * kInASlot;
    if (new_item) ltu::mbar_wait(abar + q % kInASlots, (q / kInASlots) & 1);
    ltu::mbar_wait(wbar + s % kInWSlots, (s / kInWSlots) & 1);
    const int shift = f >> 6 & 3;
    ltu::wgmma_wait<1>();  // step s - 2, the last reader of this fragment set, is done
    keep(af[SET]);
#pragma unroll
    for (int ks = 0; ks < kKT / 16; ++ks) {
      ltu::ldsm_x4(af[SET][ks],
                   slab + ltu::swz(warp * 16 + (lane & 15) + shift, ks * 2 + (lane >> 4), 8));
    }
    acc.fence();
    ltu::wgmma_fence();
    acc.step(af[SET], ltu::wgmma_desc_kmajor(wring + (s % kInWSlots) * kInWTile, 128),
             f >> 4 & 3, i == 0);
    ltu::wgmma_commit();
    acc.fence();
    if (i == a.steps - 1) {  // the tile's output, through the slot this step read
      ltu::wgmma_wait<0>();
      acc.fence();
      int b, m0;
      tile(s / a.steps, b, m0);
      store_tile<kInLanes, kInRows>(a.out + static_cast<long long>(b) * a.m * kInLanes, kInLanes,
                                    a.m, acc.v, slab, m0, tid);
    }
  };
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(s, std::integral_constant<int, 0>{});
    step(s + 1, std::integral_constant<int, 1>{});
  }
  if (s < steps) step(s, std::integral_constant<int, 0>{});
}

template <bool kHalves>
int launch_inner(const InnerArgs& a, const CUtensorMap& zmap, cudaStream_t stream) {
  // per instantiation and device, once: the shared-memory attribute and the
  // SM count (a block takes all of an SM's shared memory: one block an SM)
  static int sms[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    err = cudaFuncSetAttribute(inner_taps<kHalves>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = static_cast<long long>(a.batch) * a.row_tiles;
  const int grid = tiles < sms[device] ? static_cast<int>(tiles) : sms[device];
  inner_taps<kHalves><<<grid, kInThreads, kSmemLimit, stream>>>(a, zmap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One conv tap step on the paired layout (#11), `inner_taps`. z: bf16
// (batch, 3, hbo + 2, wc, 128) contiguous, 16-byte aligned; w: the packed
// weights (`inner_probe.pack_inner_weights`), 16-byte aligned; out: bf16
// (batch, hbo * wc, 128). plan: `inner_probe.plan_ints`: a header of 3
// (steps a tile, items a tile, elements of w) and four tables of 36 (each
// step's flags, first row and weight offset; each item's first step;
// `InnerArgs`). Launches on `stream`; returns the CUDA error (0 on
// success).
int pt_inner_step(const void* z, const void* w, void* out, int batch, int hbo, int wc,
                  const int* plan, void* stream) {
  const int w_elems = plan[2];
  InnerArgs a{};
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.batch = batch;
  a.steps = plan[0];
  a.items = plan[1];
  const long long m = static_cast<long long>(hbo) * wc, rows = m + 2LL * wc;
  if (batch < 1 || hbo < 1 || wc < 1 || a.steps < 1 || a.steps > kMaxSteps || a.items < 1 ||
      a.items > a.steps || rows > (1LL << 30) || 3LL * batch > (1LL << 30) ||
      reinterpret_cast<size_t>(z) % 16 || reinterpret_cast<size_t>(w) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.m = static_cast<int>(m);
  a.row_tiles = static_cast<int>((m + kInRows - 1) / kInRows);
  if (static_cast<long long>(batch) * a.row_tiles > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* t = plan + kInPlanHeader;
  int items = 0;
  bool halves = false;
  for (int i = 0; i < a.steps; ++i) {
    a.flags[i] = t[i];
    a.row[i] = t[kMaxSteps + i];
    a.woff[i] = t[2 * kMaxSteps + i];
    const int cols = a.flags[i] >> 4 & 3;
    const int elems = cols ? kInWTile / 2 : kInWTile;
    if (cols == 3 || (a.flags[i] >> 1 & 3) > 2 || a.woff[i] < 0 || a.woff[i] % 64 ||
        a.woff[i] + elems > w_elems || (i == 0 && (cols != 0 || !(a.flags[i] & 1)))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    halves |= cols != 0;
    if (a.flags[i] & 1) {
      if (items >= a.items || t[3 * kMaxSteps + items] != i) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      a.item_step[items++] = i;
    }
  }
  if (items != a.items) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap zmap;
  const int err = x_tensor_map(&zmap, static_cast<const bf16*>(z), 3 * batch,
                               static_cast<int>(rows), kInLanes, kInBox);
  if (err != 0) return err;
  auto s = static_cast<cudaStream_t>(stream);
  return halves ? launch_inner<true>(a, zmap, s) : launch_inner<false>(a, zmap, s);
}

// The tap sum: `taps_fold_weights`, then `taps_fold` under programmatic
// dependent launch. x: bf16 (groups, rows, k), w: bf16 (taps, k, n), out:
// bf16 (groups, m, n), all contiguous; folded: bf16 scratch of n * 64 * K
// chunks * products elements for the folded weights. plan:
// `dot_probe.tap_plan`'s ints: a header of 20 (k, n, column tile,
// 64-wide K chunks, column tiles, mode, streamed, ring slots, sub-tiles a
// slot, items a tile, distinct offsets, products, the weights' byte offset
// in shared memory and their bytes, bf16 accumulation, fold groups, the
// running sums' byte offset in shared memory) and nine tables of 32 (each
// distinct offset's rows, first product and product count; each product's
// distinct offset, part, first tap and tap count; the taps by product; each
// fold group's first product). Launches on `stream`; returns the CUDA error
// (0 on success).
int pt_tap_sum(const void* x, const void* w, void* out, void* folded, int groups, int rows,
               int m, const int* plan, void* stream) {
  const int* h = plan;
  TapArgs a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.groups = groups;
  a.rows = rows;
  a.m = m;
  a.k = h[0];
  a.n = h[1];
  a.nt = h[2];
  a.nkc = h[3];
  a.col_tiles = h[4];
  a.mode = h[5];
  a.streamed = h[6];
  a.slots = h[7];
  a.nsub = h[8];
  a.items = h[9];
  a.nd = h[10];
  a.np = h[11];
  a.w_offset = h[12];
  const int w_bytes = h[13], bf16_acc = h[14];
  a.ng = h[15];
  a.sum_offset = h[16];
  a.row_tiles = (m + kRows - 1) / kRows;
  const int ring_bytes = a.slots * a.nsub * kATile * 2;
  if (groups < 1 || m < 1 || rows < 1 || a.k < 8 || a.k % 8 || a.nkc != (a.k + kKT - 1) / kKT ||
      a.n % a.nt || a.col_tiles != a.n / a.nt || a.nd < 1 || a.nd > kMaxD || a.np < 1 ||
      a.np > kMaxP || a.ng < 1 || a.ng > a.np || a.slots < 2 || a.slots > 4 || a.nsub < 1 ||
      a.nsub > 4 || a.items < 1 || (a.mode == kWhole && a.nsub != a.nkc) ||
      a.w_offset % 1024 || a.w_offset < ring_bytes || a.w_offset + w_bytes > kTapSmem ||
      (bf16_acc && (a.sum_offset < ring_bytes || a.sum_offset + a.nt * kThreads > a.w_offset)) ||
      (a.streamed && w_bytes < (a.slots + 2) * 2 * a.nt * kKT * 2) ||
      static_cast<long long>(groups) * a.row_tiles > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* t = h + kPlanHeader;
  for (int i = 0; i < kMaxD; ++i) {
    a.d_off[i] = t[i];
    a.d_p0[i] = t[32 + i];
    a.d_np[i] = t[64 + i];
  }
  for (int i = 0; i < kMaxP; ++i) {
    a.p_d[i] = t[96 + i];
    a.p_part[i] = t[128 + i];
    a.p_t0[i] = t[160 + i];
    a.p_nt[i] = t[192 + i];
    a.tap_idx[i] = t[224 + i];
    a.g_p[i] = t[256 + i];
  }
  CUtensorMap xmap;
  const int err = x_tensor_map(&xmap, a.x, groups, rows, a.k, kRows);
  if (err != 0) return err;
  auto s = static_cast<cudaStream_t>(stream);
  auto fold = static_cast<bf16*>(folded);
  switch (a.nt) {
    case 16: return dispatch_fold<16>(a, bf16_acc, fold, xmap, s);
    case 32: return dispatch_fold<32>(a, bf16_acc, fold, xmap, s);
    case 64: return dispatch_fold<64>(a, bf16_acc, fold, xmap, s);
    case 128: return dispatch_fold<128>(a, bf16_acc, fold, xmap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
