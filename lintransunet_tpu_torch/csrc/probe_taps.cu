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
// `taps_window` (#11; `pt_forward`), the first H100 kernel of these probes,
// kept for the inner-loop probe until its own redesign. Column k of a row of
// A sits at a per-chunk base (`colbase`), so one operand can be spliced from
// several planes without a copy (the level-0 "paired" layout), and a chunk
// of K can be restricted to a range of output columns (a block-diagonal W
// whose zero blocks are skipped). A block owns 128 output rows and NT <= 128
// columns; K goes through in chunks of 32 on `mma.sync`.
// * Staging mode `window`: per K chunk, the block stages the union of its
//   taps' rows once, [m0 + min off, m0 + 128 + max off), and every tap
//   reads its operand at a shifted row of it. Weights go through 9 taps at
//   a time.
// * Mode `im2col`: the same window, but each run of three taps at
//   consecutive offsets (one dh of a 3x3 conv) first copies its three
//   shifted row slices into aligned panels, a K = 3 x 32 im2col in shared
//   memory; then the products read the panels.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128;          // output rows per block, 16 per warp
constexpr int kKC = 32;           // K per staged chunk: rows of 4 16-byte chunks
constexpr int kCpr = kKC / 8;
constexpr int kTG = 9;            // taps whose weights are staged together
constexpr int kMaxTaps = 32;
constexpr int kMaxChunks = 64;    // K up to 2048
constexpr int kSmemLimit = 232448;

enum Mode { kWindow = 0, kIm2col = 1 };

struct Args {
  const bf16* x;
  const bf16* w;
  bf16* out;
  long long gstride;   // elements between groups of A
  int rstride;         // elements between rows of A
  int rows;            // rows of A that exist: [0, rows)
  int m;               // output rows per group
  int k;               // rows of each tap's W
  int n;               // columns of W and of out
  int taps;
  int omin, omax;      // least and largest offset
  int off[kMaxTaps];
  int colbase[kMaxChunks];       // element offset of chunk kc's first column in a row
  int nlo[kMaxChunks];           // chunk kc adds to output columns [nlo, nhi)
  int nhi[kMaxChunks];
};

// rows [r0, r0 + nrows) of A's K chunk kc into a swizzled tile (zeros outside)
__device__ __forceinline__ void stage_a(bf16* dst, const Args& a, const bf16* xg, int r0,
                                        int nrows, int kc) {
  for (int i = threadIdx.x; i < nrows * kCpr; i += kThreads) {
    const int r = i / kCpr, c = i % kCpr;
    const int gr = r0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr >= 0 && gr < a.rows && kc * kKC + c * 8 < a.k) {
      v = *reinterpret_cast<const uint4*>(xg + static_cast<long long>(gr) * a.rstride +
                                          a.colbase[kc] + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + ltu::swz(r, c, kCpr)) = v;
  }
}

// K chunk kc of tap t's weights, columns [n0, n0 + NT), into a swizzled tile
template <int NT>
__device__ __forceinline__ void stage_w(bf16* dst, const Args& a, int t, int kc, int n0) {
  constexpr int cpr = NT / 8;
  for (int i = threadIdx.x; i < kKC * cpr; i += kThreads) {
    const int k = i / cpr, c = i % cpr;
    const int gk = kc * kKC + k;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gk < a.k) {
      v = *reinterpret_cast<const uint4*>(a.w + (static_cast<long long>(t) * a.k + gk) * a.n +
                                          n0 + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + ltu::swz(k, c, cpr)) = v;
  }
}

// the 16-column pairs [p_lo, p_hi) of the block's NT columns that chunk kc adds to
template <int NT>
__device__ __forceinline__ void pair_range(const Args& a, int kc, int n0, int& p_lo, int& p_hi) {
  p_lo = a.nlo[kc] <= n0 ? 0 : (a.nlo[kc] - n0) / 16;
  p_hi = a.nhi[kc] <= n0 ? 0 : min(NT / 16, (a.nhi[kc] - n0) / 16);
}

template <int NT>
__device__ __forceinline__ void store_out(const Args& a, float (&acc)[NT / 8][4], int m0, int n0) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* og = a.out + static_cast<long long>(blockIdx.y) * a.m * a.n;
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + warp * 16 + (lane >> 2) + h * 8;
      if (r < a.m) {
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<long long>(r) * a.n + col) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

__host__ __device__ constexpr int a_tile_elems(int rows) {
  return static_cast<int>(ltu::align_up(static_cast<size_t>(rows) * kKC, 64));
}

template <int NT, bool kPanels>
__global__ void __launch_bounds__(kThreads) taps_window(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wrows = kBM + a.omax - a.omin;
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_a + a_tile_elems(wrows);
  bf16* s_p = s_w + kTG * kKC * NT;  // im2col panels: 3 x kBM x kKC

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.z * NT;
  const bf16* xg = a.x + static_cast<long long>(blockIdx.y) * a.gstride;
  float acc[NT / 8][4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int chunks = (a.k + kKC - 1) / kKC;
  for (int kc = 0; kc < chunks; ++kc) {
    int p_lo, p_hi;
    pair_range<NT>(a, kc, n0, p_lo, p_hi);
    __syncthreads();  // the previous chunk's readers are done
    stage_a(s_a, a, xg, m0 + a.omin, wrows, kc);
    for (int t0 = 0; t0 < a.taps; t0 += kTG) {
      const int tg = min(kTG, a.taps - t0);
      if (t0) __syncthreads();  // the previous group's weights are read
      for (int j = 0; j < tg; ++j) stage_w<NT>(s_w + j * kKC * NT, a, t0 + j, kc, n0);
      __syncthreads();
      if constexpr (kPanels) {
        for (int j = 0; j < tg; j += 3) {
          if (j) __syncthreads();  // the previous panels are read
          for (int i = threadIdx.x; i < 3 * kBM * kCpr; i += kThreads) {
            const int u = i / (kBM * kCpr), r = (i / kCpr) % kBM, c = i % kCpr;
            const int src = r + a.off[t0 + j + u] - a.omin;
            *reinterpret_cast<uint4*>(s_p + u * kBM * kKC + ltu::swz(r, c, kCpr)) =
                *reinterpret_cast<const uint4*>(s_a + ltu::swz(src, c, kCpr));
          }
          __syncthreads();
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            ltu::warp_mma<kKC, NT>(acc, s_p + u * kBM * kKC, warp * 16,
                                   s_w + (j + u) * kKC * NT, p_lo, p_hi, lane);
          }
        }
      } else {
        for (int j = 0; j < tg; ++j) {
          ltu::warp_mma<kKC, NT>(acc, s_a, warp * 16 + a.off[t0 + j] - a.omin,
                                 s_w + j * kKC * NT, p_lo, p_hi, lane);
        }
      }
    }
  }
  store_out<NT>(a, acc, m0, n0);
}

size_t smem_bytes(int mode, int nt, int span) {
  return sizeof(bf16) * (a_tile_elems(kBM + span) + kTG * kKC * nt +
                         (mode == kIm2col ? 3 * kBM * kKC : 0));
}

template <typename Kernel>
int launch(Kernel kernel, const Args& a, int groups, int nt, int mode, cudaStream_t stream) {
  const size_t smem = smem_bytes(mode, nt, a.omax - a.omin);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.m + kBM - 1) / kBM, groups, a.n / nt);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int dispatch_mode(const Args& a, int groups, int mode, cudaStream_t s) {
  switch (mode) {
    case kWindow: return launch(taps_window<NT, false>, a, groups, NT, mode, s);
    case kIm2col: return launch(taps_window<NT, true>, a, groups, NT, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


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

// The cursor's item into ring slot `slot`, by one thread: rows [m0 + off, m0 +
// off + 128) of its K chunks, one tensor-map load (TMA) a 64-wide sub-tile,
// all completing on `bar`. The map (x as (groups, rows, k), boxes of 1 x 128
// x 64, the 128-byte swizzle, which is `ltu::swz`'s) zero-fills rows outside
// [0, rows) and K past its end, and counts those bytes too.
__device__ __forceinline__ void stage_item(bf16* slot, const TapArgs& a, const Cursor& c,
                                           const CUtensorMap* xmap, unsigned long long* bar) {
  ltu::mbar_expect_tx(bar, static_cast<unsigned>(a.nsub * kATile * 2));
  for (int sub = 0; sub < a.nsub; ++sub) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5}], [%2];\n"
        ::"r"(ltu::smem_addr(slot + sub * kATile)), "l"(xmap), "r"(ltu::smem_addr(bar)),
        "r"((c.kc + sub) * kKT), "r"(c.m0 + a.d_off[c.d]), "r"(c.g)
        : "memory");
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
// 16 KB ring slot: 128 rows of up to 64 columns, swizzled) into 16-byte
// stores of whole row segments, 64 columns at a time; rows past m are not
// stored. Every thread calls it: the block's reads of the slot come first.
template <int NT>
__device__ __forceinline__ void store_tile(const TapArgs& a, const float (&v)[NT / 2],
                                           bf16* stage, int g, int m0, int n0, int tid) {
  constexpr int kCols = NT < kKT ? NT : kKT, kCpr = kCols / 8;
  const int warp = tid >> 5, lane = tid & 31;
  bf16* og = a.out + static_cast<long long>(g) * a.m * a.n + n0;
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
    for (int i = tid; i < kRows * kCpr; i += kThreads) {
      const int r = i / kCpr, c = i % kCpr;
      if (m0 + r >= a.m) continue;
      *reinterpret_cast<uint4*>(og + static_cast<long long>(m0 + r) * a.n + cb + c * 8) =
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
      if constexpr (kBf16Acc) {
        load_sum(tot, sum, tid);
        store_tile<NT>(a, tot, stage, cu.g, cu.m0, n0, tid);
      } else {
        wait_sum(acc, tot);
        store_tile<NT>(a, tot, stage, cu.g, cu.m0, n0, tid);
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

// x (groups, rows, k) bf16 as a tensor map of 1 x 128 x 64 boxes with the
// 128-byte swizzle, zeros outside (`stage_item`); the driver's encoder is
// found once through the runtime, so nothing links the driver library.
int x_tensor_map(CUtensorMap* map, const bf16* x, int groups, int rows, int k) {
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
  const cuuint32_t box[3] = {kKT, kRows, 1}, unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}


}  // namespace

extern "C" {

// Shared memory one block of `mode` takes with column tile `n_tile` and
// offset span (largest - least offset); the wrapper checks it against the
// card's limit before a launch.
int pt_smem_bytes(int mode, int n_tile, int span) {
  return static_cast<int>(smem_bytes(mode, n_tile, span));
}

// x: bf16 A, group g at x + g * gstride, row r at + r * rstride, chunk kc
// of K at + colbase[kc]; w: bf16 (taps, k, n) contiguous; out: bf16
// (groups, m, n) contiguous. off: taps row offsets; colbase, nlo, nhi:
// ceil(k / 32) entries each (nlo, nhi multiples of 16). n_tile in {16, 32,
// 64, 128} divides n; k and every colbase are multiples of 8. mode: 0
// window, 1 im2col (taps a multiple of 3). Launches on `stream`; returns the
// CUDA error (0 on success).
int pt_forward(const void* x, const void* w, void* out, long long gstride, int rstride,
               int rows, int m, int k, int n, int groups, int taps, const int* off,
               const int* colbase, const int* nlo, const int* nhi, int n_tile, int mode,
               void* stream) {
  const int chunks = (k + kKC - 1) / kKC;
  if (taps < 1 || taps > kMaxTaps || chunks > kMaxChunks || n % n_tile != 0 ||
      (mode == kIm2col && taps % 3 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.out = static_cast<bf16*>(out);
  a.gstride = gstride;
  a.rstride = rstride;
  a.rows = rows;
  a.m = m;
  a.k = k;
  a.n = n;
  a.taps = taps;
  a.omin = off[0];
  a.omax = off[0];
  for (int t = 0; t < taps; ++t) {
    a.off[t] = off[t];
    a.omin = off[t] < a.omin ? off[t] : a.omin;
    a.omax = off[t] > a.omax ? off[t] : a.omax;
  }
  for (int c = 0; c < chunks; ++c) {
    a.colbase[c] = colbase[c];
    a.nlo[c] = nlo[c];
    a.nhi[c] = nhi[c];
  }
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_tile) {
    case 16: return dispatch_mode<16>(a, groups, mode, s);
    case 32: return dispatch_mode<32>(a, groups, mode, s);
    case 64: return dispatch_mode<64>(a, groups, mode, s);
    case 128: return dispatch_mode<128>(a, groups, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
  const int err = x_tensor_map(&xmap, a.x, groups, rows, a.k);
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
