// Tap-sum probe kernel for Hopper (sm_90a), bound with ctypes.
//
// For each group g of a bf16 operand A and per-tap bf16 weights W (T, K, N):
//
//   out[g, r, n] = sum_t sum_k A[g, r + off[t], k] * W[t, k, n],  0 <= r < m
//
// with rows of A outside [0, rows) read as zero, summed in f32 and stored
// as bf16. Column k of a row of A sits at a per-chunk base (`colbase`), so
// one operand can be spliced from several planes without a copy (the
// level-0 "paired" layout of the inner-loop probe), and a chunk of K can be
// restricted to a range of output columns (a block-diagonal W whose zero
// blocks are skipped).
//
// Replaces three TPU probe kernels, which compute this function:
//   experiments/pallas_dot_probe.py `bench` (pallas_call at :41): offsets 0;
//   experiments/pallas_rowoffset_probe.py `make_kernel` (pallas_call at :53):
//     9 taps at row offsets 0, k * 576 or k * 577;
//   experiments/pallas_inner_probe.py `make_kernel` (pallas_call at :226):
//     one conv tap step on the paired layout, 9 (dh, dw) taps.
//
// What bounds it on this card: operations at every probe shape (each row
// of A is used by all N columns and all taps: 100-1000 FLOP per compulsory
// byte, above the H100's ~295 FLOP/byte bf16 ridge). This first design
// keeps a tensor-core inner loop simple and measurable, not fast:
//
// * A block owns 128 output rows (16 per warp) and NT <= 128 columns. K goes
//   through in chunks of 32; `mma.sync` m16n8k16 via `ldmatrix` from
//   XOR-swizzled shared memory (csrc/tensor_core.cuh), f32 accumulators.
// * Staging mode `window`: per K chunk, the block stages the union of its
//   taps' rows once, [m0 + min off, m0 + 128 + max off), and every tap
//   reads its operand at a shifted row of it. The swizzle is keyed on the
//   staged row, so a shift that is not a multiple of 8 rows reads without
//   bank conflicts. Weights go through 9 taps at a time.
// * Mode `im2col`: the same window, but each run of three taps at
//   consecutive offsets (one dh of a 3x3 conv) first copies its three
//   shifted row slices into aligned panels, a K = 3 x 32 im2col in shared
//   memory; then the products read the panels.
// * Mode `per_tap`: per tap and K chunk, the block stages the tap's own 128
//   rows (re-read from L2 for every tap) and the tap's weights. The only
//   mode with bf16 accumulation (each tap's f32 product rounded to bf16,
//   then added to a bf16 sum), which needs each tap's product whole.
// * No wgmma, TMA or multi-stage pipeline: a later PR's work.

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

enum Mode { kWindow = 0, kIm2col = 1, kPerTap = 2, kPerTapBf16Acc = 3 };

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
  extern __shared__ __align__(128) unsigned char smem[];
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

template <int NT, bool kBf16Acc>
__global__ void __launch_bounds__(kThreads) taps_per_tap(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem);
  bf16* s_w = s_a + a_tile_elems(kBM);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.z * NT;
  const bf16* xg = a.x + static_cast<long long>(blockIdx.y) * a.gstride;
  float acc[NT / 8][4], tap[NT / 8][4];
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = tap[j][e] = 0.f;
  }

  const int chunks = (a.k + kKC - 1) / kKC;
  for (int t = 0; t < a.taps; ++t) {
    for (int kc = 0; kc < chunks; ++kc) {
      int p_lo, p_hi;
      pair_range<NT>(a, kc, n0, p_lo, p_hi);
      __syncthreads();
      stage_a(s_a, a, xg, m0 + a.off[t], kBM, kc);
      stage_w<NT>(s_w, a, t, kc, n0);
      __syncthreads();
      if constexpr (kBf16Acc) {
        ltu::warp_mma<kKC, NT>(tap, s_a, warp * 16, s_w, p_lo, p_hi, lane);
      } else {
        ltu::warp_mma<kKC, NT>(acc, s_a, warp * 16, s_w, p_lo, p_hi, lane);
      }
    }
    if constexpr (kBf16Acc) {
      // acc = bf16(acc + bf16(tap)): the sum of two bf16 values, rounded
#pragma unroll
      for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] = ltu::round_to<bf16>(acc[j][e] + ltu::round_to<bf16>(tap[j][e]));
          tap[j][e] = 0.f;
        }
      }
    }
  }
  store_out<NT>(a, acc, m0, n0);
}

size_t smem_bytes(int mode, int nt, int span) {
  if (mode == kPerTap || mode == kPerTapBf16Acc) {
    return sizeof(bf16) * (a_tile_elems(kBM) + kKC * nt);
  }
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
    case kPerTap: return launch(taps_per_tap<NT, false>, a, groups, NT, mode, s);
    case kPerTapBf16Acc: return launch(taps_per_tap<NT, true>, a, groups, NT, mode, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// window, 1 im2col (taps a multiple of 3), 2 per tap, 3 per tap with bf16
// accumulation. Launches on `stream`; returns the CUDA error (0 on success).
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

}  // extern "C"
