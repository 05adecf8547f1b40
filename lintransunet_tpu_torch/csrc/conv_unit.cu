// Stride-1 3x3x3 convolution unit for Hopper (sm_90a), bound with ctypes.
//
// On contiguous (N, C, H, W, D) activations it computes, per volume n:
//
//   a   = act(xa * scale_a[n, c] + shift_a[n, c]), act = LeakyReLU(0.01),
//         or xa itself without an affine; 0 outside the volume (the conv's
//         zero padding applies to the activation, not to xa)
//   b   = the same for the optional second input xb (the UpBlock concat)
//   y   = bias + conv(a, wa) + conv(b, wb), stored in the input dtype
//   stats[n, 0, o] = sum of y as stored, stats[n, 1, o] = sum of y^2 (f32)
//   z   = a (optional)
//
// The input and output dtype TI is bf16 or f32. Operands are rounded to the
// compute dtype (bf16 or f32) when they are staged in shared memory, and
// products are summed in f32. The model's callers take bf16 operands
// whatever TI is, as the TPU kernel's `compute_dtype` default does.
//
// Replaces the Pallas TPU kernel `_build_kernel` of
// lintransunet_tpu/ops/pallas_conv.py (pallas_call at :625, via
// `fused_s1_canvas`): the previous InstanceNorm + LeakyReLU in the
// prologue, the next InstanceNorm's statistics in the epilogue, so neither
// the normalised activation nor the UpBlock concat is written to memory.
//
// What bounds it on this card: both, by shape. The flagship's seven units
// are ~594 GFLOP against ~1.8 GB of compulsory traffic per window, ~330
// FLOP per byte, near the H100's ~295 FLOP/byte ridge in bf16: the units at
// 128 x 128 x 64 with 32 outputs are bound by operations, the 256 x 256 x 64
// ones with 16 outputs by bytes.
//
// bf16 operands (`conv_unit_mma`, the model's path): an implicit GEMM on
// the tensor cores through `mma.sync` m16n8k16 (csrc/tensor_core.cuh).
// * Weights: the wrapper packs them once per call into bf16
//   [output tile][K chunk][tap][16 input channels][NT outputs]. A block
//   copies its output tile's weights into shared memory once, with 16-byte
//   loads into XOR-swizzled rows, and keeps them there while it walks its
//   output tiles (110.6 KB at the largest unit, (32 + 32) -> 32). Where
//   they do not fit beside the halo, each K chunk's weights are copied
//   again per tile.
// * Persistent grid: (blocks per volume and output tile) x (output tiles of
//   NT = 16 or 32 channels) x N, as many blocks as fit on the card at once.
//   Block b walks the volume's output tiles b, b + G, ... and keeps its own
//   per-channel sums of y and y^2; it writes one partial per block, and
//   `stats_reduce` adds the partials in a fixed order. No float atomics, so
//   the statistics are the same bits from run to run.
// * Output tile: 4 (h) x 4 (w) x 32 (d), M = 512 positions. Per K chunk of
//   16 input channels the block stages the 6 x 6 x 34 halo (1,224 positions,
//   2.39 per output position) once: 16-byte global loads along d, the
//   prologue in f32 registers (the multiply and the add each rounded, as
//   the plain version), then one row of 16 bf16 channels per position,
//   swizzled by `ltu::swz`. Tap (kh, kw, kd) reads the rows of a warp's
//   positions shifted by a whole number of rows.
// * MMA: a warp owns four 16-row tiles, the same 16 positions along d in
//   each of the tile's 4 w columns, and all NT outputs (f32 accumulators).
//   Per tap it loads the B fragments once with `ldmatrix.trans` and reuses
//   them over its four A tiles; per (kh, kd) it loads the A fragments of
//   the 6 halo columns once and uses each for up to three kw taps.
// * Epilogue: bias, rounding to TI, then 16 channels at a time through
//   shared memory to 16-byte stores along d (NCDHW). z is written from the
//   registers of the staged values.
// * Two blocks share an SM where the resident weights allow, so that one
//   block's staging overlaps the other's MMAs; where they leave room for
//   only one block per SM, it may use up to 255 registers a thread.
// What still separates it from the bound, as measured on an H100: staging
// takes about half of a block's time (clock64 phases), and within a block
// it does not overlap the MMAs. Two ways to overlap it were tried and lost
// at these shapes: a register prefetch of the next chunk (spills at 128
// registers) and warp specialisation (9 staging warps filling a double
// buffer for 8 MMA warps, named barriers; faster at NT = 32, slower at
// NT = 16 for want of a second block per SM). Past that: `wgmma` on 64-row
// tiles and TMA loads.
//
// f32 operands (`conv_unit_fma`, compute_dtype=float32): a block takes
// 2 (w) x 64 (d) outputs at one h and stages a 3 x 4 x 66 halo per chunk of
// 16 input channels with the chunk's weights; one thread per position and
// 8 or 16 output channels, FMA in f32.

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ltu::from_f32;
using ltu::to_f32;
using ltu::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 16;                // input channels per K chunk
constexpr float kSlope = 0.01f;        // LeakyReLU negative slope
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may use

// act(v * scale + shift): a multiply and an add, each rounded, as the plain
// version's two ops: a fused multiply-add would move some values across a
// bf16 rounding boundary and the operand by a bf16 ulp
__device__ __forceinline__ float prologue(float v, float scale, float shift) {
  v = __fadd_rn(__fmul_rn(v, scale), shift);
  return v >= 0.f ? v : v * kSlope;
}

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTH = 4, kTW = 4, kTD = 32;                  // output tile
constexpr int kHH = kTH + 2, kHW = kTW + 2, kHD = kTD + 2;  // its halo
constexpr int kRows = kHH * kHW * kHD;                     // staged positions
constexpr int kM = kTH * kTW * kTD;                        // output positions
constexpr int kR = kM / 16 / kWarps;                       // 16-row tiles per warp
constexpr int kOutStride = kM + 4;                         // s_out row: no bank conflicts
constexpr int kDPT = 16;                                   // d per staging item
constexpr int kPieces = kTD / kDPT;
constexpr int kItems = kKC * kHH * kHW * kPieces;          // staging items per chunk
constexpr size_t kHaloBytes = sizeof(bf16) * kRows * kKC;
constexpr size_t kRunBytes = sizeof(float) * kWarps * 2 * 32;  // running sums
constexpr size_t kWeightsOffset = ltu::align_up(kHaloBytes + kRunBytes, 128);

static_assert(kR * kWarps * 16 == kM && kTD % 16 == 0, "whole 16-row tiles along d");
static_assert(kPieces == 2, "each staging item also takes one edge of the d halo");
static_assert(sizeof(float) * 16 * kOutStride <= kHaloBytes, "s_out fits in s_in");

template <int NT>
__host__ __device__ constexpr size_t slab_elems() { return 27 * kKC * NT; }

struct MmaArgs {
  const void* xa;         // (N, Ca, H, W, D), TI
  const void* xb;         // (N, Cb, H, W, D), TI, or null
  const float* aff_a;     // (N, 2, Ca) f32 scale, shift; or null
  const float* aff_b;
  int ca, cb;
  const bf16* w;          // packed (G, chunks, 27, 16, NT), see pack_weights
  const float* bias;      // (n_out,) or null
  void* y;
  void* z;                // like xa, or null
  float* part;            // (N, gx, 2, n_out) or null
  int n_out, H, W, D;
  int tiles_h, tiles_w, tiles_d, gx;
  int resident;           // all chunks' weights stay in shared memory
  int vec;                // D is a multiple of the 16-byte vector widths
};

// `slabs` slabs of 16 x NT packed weights -> shared memory, rows swizzled
template <int NT>
__device__ __forceinline__ void load_weights(bf16* s_w, const bf16* __restrict__ w, int slabs,
                                             int tid) {
  constexpr int kCpr = NT / 8;
  const int pieces = slabs * kKC * kCpr;
  for (int i = tid; i < pieces; i += kThreads) {
    const int c = i % kCpr, r = i / kCpr;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(w) + i);
    *reinterpret_cast<uint4*>(s_w + (r / kKC) * kKC * NT + ltu::swz(r % kKC, c, kCpr)) = v;
  }
}

// 16 values of x from x[0..16): bf16 or f32, 16-byte loads
__device__ __forceinline__ void load16(float (&v)[kDPT], const bf16* p) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[k]));
      v[q * 8 + 2 * k] = f.x;
      v[q * 8 + 2 * k + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void load16(float (&v)[kDPT], const float* p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + q);
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// two floats as one word of two bf16, the first in the low half
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void store16(bf16* p, const float (&v)[kDPT]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* f = v + q * 8;
    reinterpret_cast<uint4*>(p)[q] = make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                                                pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[kDPT]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                  v[4 * q + 3]);
  }
}

// Stages channels [c0, c0 + 16) of x for the output tile at (h0, w0, d0):
// s_in row (hh, ww, dd) holds act(x) at (h0 + hh - 1, w0 + ww - 1,
// d0 + dd - 1), rounded to bf16, 0 outside the volume. An item is one
// channel's 16 consecutive d at one (hh, ww) and one d-edge of the halo;
// lanes run over the 16 channels, then over ww, so that a warp's stores of
// one position fall in distinct banks. With `z`, writes act(x) as rounded
// at the tile's own positions.
template <typename TI>
__device__ __forceinline__ void stage_chunk(bf16* __restrict__ s_in, const TI* __restrict__ x,
                                            const float* __restrict__ aff, int C, int c0, int n,
                                            int h0, int w0, int d0, const MmaArgs& a,
                                            TI* __restrict__ z, int tid) {
  // one item at a time: a deeper unroll lets the compiler hoist every
  // item's loads, and the registers spill
#pragma unroll 1
  for (int item = tid; item < kItems; item += kThreads) {
    const int c = item % kKC;
    int r = item / kKC;
    const int ww = r % kHW;
    r /= kHW;
    const int hh = r % kHH;
    const int piece = r / kHH;
    const int gc = c0 + c, gh = h0 + hh - 1, gw = w0 + ww - 1;
    const int dbase = d0 + piece * kDPT;
    const int ed = piece == 0 ? d0 - 1 : d0 + kTD;
    const bool inside = gc < C && gh >= 0 && gh < a.H && gw >= 0 && gw < a.W;
    const size_t off = ((static_cast<size_t>(n) * C + gc) * a.H + gh) * a.W * a.D +
                       static_cast<size_t>(gw) * a.D;
    float v[kDPT];
    float edge = 0.f;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) v[i] = 0.f;
    if (inside) {
      const TI* row = x + off;
      if (a.vec && dbase + kDPT <= a.D) {
        load16(v, row + dbase);
      } else {
#pragma unroll
        for (int i = 0; i < kDPT; ++i) {
          if (dbase + i < a.D) v[i] = to_f32(row[dbase + i]);
        }
      }
      if (ed >= 0 && ed < a.D) edge = to_f32(row[ed]);
      if (aff != nullptr) {
        const float scale = __ldg(aff + (n * 2) * C + gc);
        const float shift = __ldg(aff + (n * 2 + 1) * C + gc);
#pragma unroll
        for (int i = 0; i < kDPT; ++i) {
          if (dbase + i < a.D) v[i] = prologue(v[i], scale, shift);
        }
        if (ed >= 0 && ed < a.D) edge = prologue(edge, scale, shift);
      }
    }
    const int srow = (hh * kHW + ww) * kHD;
    const int chunk = c >> 3, lane_c = c & 7;
#pragma unroll
    for (int i = 0; i < kDPT; ++i) {
      const bf16 q = __float2bfloat16(v[i]);
      s_in[ltu::swz(srow + 1 + piece * kDPT + i, chunk, 2) + lane_c] = q;
      v[i] = __bfloat162float(q);
    }
    s_in[ltu::swz(srow + (piece == 0 ? 0 : kHD - 1), chunk, 2) + lane_c] = __float2bfloat16(edge);
    if (z != nullptr && inside && hh >= 1 && hh <= kTH && ww >= 1 && ww <= kTW) {
      TI* dst = z + off + dbase;
      if (a.vec && dbase + kDPT <= a.D) {
        store16(dst, v);
      } else {
#pragma unroll
        for (int i = 0; i < kDPT; ++i) {
          if (dbase + i < a.D) dst[i] = from_f32<TI>(v[i]);
        }
      }
    }
  }
}

// A warp's 16-row tiles: warp w owns h row w / 2 of the tile, the 16 d
// positions starting at 16 (w % 2), and the tile's kTW = 4 w columns, one
// tile per column: tile j is output column (w / 2) * kTW + j.
static_assert(kR == kTW && kWarps == kTH * (kTD / 16), "a warp owns one h row's w columns");

// acc[j] += the chunk's 27 taps for the warp's 16-row tile j. Tap
// (kh, kw, kd) of column j reads halo column j + kw, so per (kh, kd) the
// warp loads the 6 halo columns' A fragments once and uses each for up to
// three taps.
template <int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[kR][NT / 8][4], const bf16* s_in,
                                          const bf16* s_w, int warp, int lane) {
  const int hl = warp / (kTD / 16), dh = warp % (kTD / 16);
#pragma unroll 1
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll 1
    for (int kd = 0; kd < 3; ++kd) {
      const int r0 = (hl + kh) * kHW * kHD + dh * 16 + kd + (lane & 15);
      unsigned af[kHW][4];
#pragma unroll
      for (int c = 0; c < kHW; ++c) {
        ltu::ldsm_x4(af[c], s_in + ltu::swz(r0 + c * kHD, lane >> 4, 2));
      }
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = (kh * 3 + kw) * 3 + kd;
        unsigned b[NT / 16][4];
#pragma unroll
        for (int p = 0; p < NT / 16; ++p) {
          ltu::ldsm_x4_t(b[p], s_w + tap * kKC * NT +
                                   ltu::swz(lane & 15, p * 2 + (lane >> 4), NT / 8));
        }
#pragma unroll
        for (int j = 0; j < kR; ++j) {
#pragma unroll
          for (int p = 0; p < NT / 16; ++p) {
            ltu::mma_bf16_16816(acc[j][2 * p], af[j + kw], b[p][0], b[p][1]);
            ltu::mma_bf16_16816(acc[j][2 * p + 1], af[j + kw], b[p][2], b[p][3]);
          }
        }
      }
    }
  }
}

// Bias, rounding to TI, the store of y, and the tile's sums into the warp's
// running sums s_run[warp][0 / 1][o] (lanes 0..3, fixed order).
template <typename TI, int NT>
__device__ __forceinline__ void epilogue(float (&acc)[kR][NT / 8][4], float* s_out,
                                         float* s_run, const MmaArgs& a, int n, int o0, int h0,
                                         int w0, int d0, int tid, int warp, int lane) {
  constexpr int kVec = 16 / sizeof(TI);
  constexpr int kPiecesOut = kTD / kVec;
  float ts[NT / 4], tq[NT / 4];
#pragma unroll
  for (int s = 0; s < NT / 4; ++s) ts[s] = tq[s] = 0.f;
  TI* y = static_cast<TI*>(a.y);
#pragma unroll
  for (int half = 0; half < NT / 16; ++half) {
    if (half) __syncthreads();  // the previous half's stores have read s_out
#pragma unroll
    for (int t = 2 * half; t < 2 * half + 2; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = t * 8 + 2 * (lane & 3) + (e & 1);
        const int go = o0 + o;
        const float bias = (a.bias != nullptr && go < a.n_out) ? __ldg(a.bias + go) : 0.f;
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          const int col = warp / (kTD / 16) * kTW + j;
          const int dl = warp % (kTD / 16) * 16 + (lane >> 2) + 8 * (e >> 1);
          const float yv = ltu::round_to<TI>(acc[j][t][e] + bias);
          const bool valid = go < a.n_out && h0 + col / kTW < a.H && w0 + col % kTW < a.W &&
                             d0 + dl < a.D;
          const float sv = valid ? yv : 0.f;
          ts[t * 2 + (e & 1)] += sv;
          tq[t * 2 + (e & 1)] += sv * sv;
          s_out[(o - half * 16) * kOutStride + col * kTD + dl] = yv;
        }
      }
    }
    __syncthreads();
    for (int it = tid; it < 16 * kTH * kTW * kPiecesOut; it += kThreads) {
      const int piece = it % kPiecesOut;
      const int col = (it / kPiecesOut) % (kTH * kTW);
      const int ol = it / (kPiecesOut * kTH * kTW);
      const int go = o0 + half * 16 + ol;
      const int gh = h0 + col / kTW, gw = w0 + col % kTW, gd = d0 + piece * kVec;
      if (go >= a.n_out || gh >= a.H || gw >= a.W || gd >= a.D) continue;
      const float* src = s_out + ol * kOutStride + col * kTD + piece * kVec;
      TI* dst = y + ((static_cast<size_t>(n) * a.n_out + go) * a.H + gh) * a.W * a.D +
                static_cast<size_t>(gw) * a.D + gd;
      if (a.vec && gd + kVec <= a.D) {
        if constexpr (std::is_same<TI, float>::value) {
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
        } else {
          const float4 lo = reinterpret_cast<const float4*>(src)[0];
          const float4 hi = reinterpret_cast<const float4*>(src)[1];
          *reinterpret_cast<uint4*>(dst) = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w),
                                                      pack2(hi.x, hi.y), pack2(hi.z, hi.w));
        }
      } else {
        for (int i = 0; i < kVec && gd + i < a.D; ++i) dst[i] = from_f32<TI>(src[i]);
      }
    }
  }
  // the tile's sums over the warp's rows (lanes with one lane % 4 share
  // columns), added to the warp's running sums in tile order
#pragma unroll
  for (int s = 0; s < NT / 4; ++s) {
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      ts[s] += __shfl_xor_sync(ltu::kFullMask, ts[s], m);
      tq[s] += __shfl_xor_sync(ltu::kFullMask, tq[s], m);
    }
    if (lane < 4) {
      const int o = (s >> 1) * 8 + 2 * lane + (s & 1);
      s_run[(warp * 2 + 0) * 32 + o] += ts[s];
      s_run[(warp * 2 + 1) * 32 + o] += tq[s];
    }
  }
}

// Wide: the weights leave room for one block per SM, which may then use up
// to 255 registers a thread; otherwise two blocks share an SM.
template <typename TI, int NT, bool Wide>
__global__ void __launch_bounds__(kThreads, Wide ? 1 : 2) conv_unit_mma(const MmaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_in = reinterpret_cast<bf16*>(smem);
  float* s_out = reinterpret_cast<float*>(smem);  // reuses s_in after the K loop
  float* s_run = reinterpret_cast<float*>(smem + kHaloBytes);
  bf16* s_w = reinterpret_cast<bf16*>(smem + kWeightsOffset);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.z;
  const int o0 = blockIdx.y * NT;
  const int chunks_a = (a.ca + kKC - 1) / kKC;
  const int chunks = chunks_a + (a.cb + kKC - 1) / kKC;
  const bf16* w = a.w + static_cast<size_t>(blockIdx.y) * chunks * slab_elems<NT>();
  if (a.resident) load_weights<NT>(s_w, w, chunks * 27, tid);
  for (int i = tid; i < kWarps * 2 * 32; i += kThreads) s_run[i] = 0.f;

  const int tiles = a.tiles_h * a.tiles_w * a.tiles_d;
  for (int t = blockIdx.x; t < tiles; t += a.gx) {
    const int d0 = (t % a.tiles_d) * kTD;
    const int w0 = (t / a.tiles_d % a.tiles_w) * kTW;
    const int h0 = t / (a.tiles_d * a.tiles_w) * kTH;
    float acc[kR][NT / 8][4];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int q = 0; q < NT / 8; ++q) acc[j][q][0] = acc[j][q][1] = acc[j][q][2] = acc[j][q][3] = 0.f;
    }
    for (int ch = 0; ch < chunks; ++ch) {
      const bool second = ch >= chunks_a;
      __syncthreads();  // the previous chunk's (or tile's) readers are done
      if (second) {
        stage_chunk<TI>(s_in, static_cast<const TI*>(a.xb), a.aff_b, a.cb,
                        (ch - chunks_a) * kKC, n, h0, w0, d0, a, nullptr, tid);
      } else {
        stage_chunk<TI>(s_in, static_cast<const TI*>(a.xa), a.aff_a, a.ca, ch * kKC, n, h0,
                        w0, d0, a, blockIdx.y == 0 ? static_cast<TI*>(a.z) : nullptr, tid);
      }
      if (!a.resident) load_weights<NT>(s_w, w + ch * slab_elems<NT>(), 27, tid);
      __syncthreads();
      mma_chunk<NT>(acc, s_in, s_w + (a.resident ? ch * slab_elems<NT>() : 0), warp, lane);
    }
    __syncthreads();  // s_in is reused as s_out
    epilogue<TI, NT>(acc, s_out, s_run, a, n, o0, h0, w0, d0, tid, warp, lane);
  }
  if (a.part == nullptr) return;
  __syncthreads();
  // the block's partial: the warps' running sums added in warp order
  if (tid < 2 * NT) {
    const int s = tid / NT, o = tid % NT;
    float acc = 0.f;
    for (int wp = 0; wp < kWarps; ++wp) acc += s_run[(wp * 2 + s) * 32 + o];
    if (o0 + o < a.n_out) {
      a.part[((static_cast<size_t>(n) * a.gx + blockIdx.x) * 2 + s) * a.n_out + o0 + o] = acc;
    }
  }
}

struct Plan {
  size_t smem;
  int resident, gx, groups;
  void (*kernel)(MmaArgs);
};

// Shared memory, weight residency and grid of the bf16 kernel for a call.
template <typename TI, int NT>
cudaError_t plan_mma(int ca, int cb, int n, int n_out, int h, int w, int d, Plan* p) {
  const int chunks = (ca + kKC - 1) / kKC + (cb + kKC - 1) / kKC;
  const size_t slab = sizeof(bf16) * slab_elems<NT>();
  p->resident = kWeightsOffset + chunks * slab <= static_cast<size_t>(kSmemLimit);
  p->smem = kWeightsOffset + (p->resident ? chunks : 1) * slab;
  p->kernel = 2 * p->smem > static_cast<size_t>(kSmemLimit) ? conv_unit_mma<TI, NT, true>
                                                             : conv_unit_mma<TI, NT, false>;
  cudaError_t err = cudaFuncSetAttribute(p->kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(p->smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p->kernel, kThreads,
                                                      p->smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  p->groups = (n_out + NT - 1) / NT;
  const long long tiles = static_cast<long long>((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW) *
                          ((d + kTD - 1) / kTD);
  const long long per_volume = (static_cast<long long>(sms) * per_sm + n * p->groups - 1) /
                               (static_cast<long long>(n) * p->groups);
  p->gx = static_cast<int>(per_volume < tiles ? (per_volume > 0 ? per_volume : 1) : tiles);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// f32 operands: FMA
// ---------------------------------------------------------------------------

constexpr int kFW = 2;                       // output w positions per block
constexpr int kFD = 64;                      // output d positions per block
constexpr int kFM = kFW * kFD;               // output voxels per block
constexpr int kFHaloW = kFW + 2;
constexpr int kFHaloD = kFD + 2;
constexpr int kFHalo = 3 * kFHaloW * kFHaloD;  // halo positions per channel
constexpr int kFStride = kKC + 1;            // channel stride: no bank conflicts

template <int NT>
__host__ __device__ constexpr size_t fma_weights_offset() {
  return ltu::align_up(sizeof(float) * kFHalo * kFStride, 128);
}

template <int NT>
__host__ __device__ constexpr size_t fma_smem_bytes() {
  return fma_weights_offset<NT>() + sizeof(float) * 27 * kKC * NT;
}

struct Input {
  const void* x;         // (N, C, H, W, D), TI
  const float* w;        // element (o, c, tap) at w[(o * cstride + c) * 27 + tap]
  int cstride;
  const float* affine;   // (N, 2, C) f32 scale, shift; or null
  int c;                 // channels
};

template <typename TI, int NT>
__global__ void __launch_bounds__(kThreads)
conv_unit_fma(Input in_a, Input in_b, const float* __restrict__ bias, TI* __restrict__ y,
              TI* __restrict__ z, float* __restrict__ part, int n_out, int H, int W, int D,
              int tiles_w, int tiles_d) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_in = reinterpret_cast<float*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + fma_weights_offset<NT>());
  float* s_out = s_in;  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int t = blockIdx.x;
  const int td = t % tiles_d;
  t /= tiles_d;
  const int tw = t % tiles_w;
  const int h = t / tiles_w;
  const int w0 = tw * kFW;
  const int d0 = td * kFD;
  const int n = blockIdx.y;
  const int o0 = blockIdx.z * NT;
  const size_t plane = static_cast<size_t>(H) * W * D;

  // thread -> voxel tid % kFM, channels (tid / kFM) * OPT + [0, OPT)
  constexpr int OPT = NT * kFM / kThreads;
  float acc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) acc[j] = 0.f;

  for (int src = 0; src < 2; ++src) {
    const Input& in = src == 0 ? in_a : in_b;
    if (in.x == nullptr) continue;
    const TI* x = static_cast<const TI*>(in.x);
    for (int c0 = 0; c0 < in.c; c0 += kKC) {
      __syncthreads();  // the previous chunk's readers are done
      // halo of channels [c0, c0 + kKC), prologue applied, zeros outside
      for (int idx = tid; idx < kKC * kFHalo; idx += kThreads) {
        const int dd = idx % kFHaloD;
        int r = idx / kFHaloD;
        const int ww = r % kFHaloW;
        r /= kFHaloW;
        const int hh = r % 3;
        const int c = r / 3;
        const int gc = c0 + c, gh = h + hh - 1, gw = w0 + ww - 1, gd = d0 + dd - 1;
        float v = 0.f;
        if (gc < in.c && gh >= 0 && gh < H && gw >= 0 && gw < W && gd >= 0 && gd < D) {
          v = to_f32(x[(static_cast<size_t>(n) * in.c + gc) * plane +
                       (static_cast<size_t>(gh) * W + gw) * D + gd]);
          if (in.affine != nullptr) {
            v = prologue(v, in.affine[(n * 2) * in.c + gc], in.affine[(n * 2 + 1) * in.c + gc]);
          }
        }
        s_in[((hh * kFHaloW + ww) * kFHaloD + dd) * kFStride + c] = v;
      }
      // weights of the chunk: s_w[tap][c][o], zero-padded
      for (int idx = tid; idx < NT * kKC * 27; idx += kThreads) {
        const int tap = idx % 27;
        const int c = (idx / 27) % kKC;
        const int o = idx / (27 * kKC);
        const int gc = c0 + c, go = o0 + o;
        s_w[(tap * kKC + c) * NT + o] = (gc < in.c && go < n_out)
            ? in.w[(static_cast<size_t>(go) * in.cstride + gc) * 27 + tap] : 0.f;
      }
      __syncthreads();

      if (z != nullptr && src == 0 && blockIdx.z == 0) {
        // z = the prologued input at the block's own voxels
        for (int idx = tid; idx < kKC * kFM; idx += kThreads) {
          const int dd = idx % kFD;
          const int ww = (idx / kFD) % kFW;
          const int c = idx / kFM;
          const int gc = c0 + c, gw = w0 + ww, gd = d0 + dd;
          if (gc < in.c && gw < W && gd < D) {
            z[(static_cast<size_t>(n) * in.c + gc) * plane +
              (static_cast<size_t>(h) * W + gw) * D + gd] =
                from_f32<TI>(s_in[((1 * kFHaloW + ww + 1) * kFHaloD + dd + 1) * kFStride + c]);
          }
        }
      }

      const int m = tid % kFM;
      const int og = tid / kFM;
      const int wl = m / kFD;
      const int dl = m % kFD;
      for (int kh = 0; kh < 3; ++kh) {
        for (int kw = 0; kw < 3; ++kw) {
          for (int kd = 0; kd < 3; ++kd) {
            const int tap = (kh * 3 + kw) * 3 + kd;
            const float* a_row = s_in + ((kh * kFHaloW + wl + kw) * kFHaloD + dl + kd) * kFStride;
            const float* w_row = s_w + tap * kKC * NT + og * OPT;
#pragma unroll 4
            for (int c = 0; c < kKC; ++c) {
              const float av = a_row[c];
#pragma unroll
              for (int j = 0; j < OPT; ++j) acc[j] += av * w_row[c * NT + j];
            }
          }
        }
      }
    }
  }
  __syncthreads();  // s_in is reused as s_out below

  {
    const int m = tid % kFM;
    const int og = tid / kFM;
#pragma unroll
    for (int j = 0; j < OPT; ++j) s_out[m * NT + og * OPT + j] = acc[j];
  }
  __syncthreads();

  // bias, round, store; keep the stored value (0 off the volume) for stats
  for (int idx = tid; idx < NT * kFM; idx += kThreads) {
    const int o = idx / kFM;
    const int m = idx % kFM;
    const int go = o0 + o, gw = w0 + m / kFD, gd = d0 + m % kFD;
    const bool valid = go < n_out && gw < W && gd < D;
    float v = s_out[m * NT + o];
    if (bias != nullptr && go < n_out) v += bias[go];
    const TI yv = from_f32<TI>(v);
    if (valid) {
      y[(static_cast<size_t>(n) * n_out + go) * plane +
        (static_cast<size_t>(h) * W + gw) * D + gd] = yv;
    }
    s_out[m * NT + o] = valid ? to_f32(yv) : 0.f;
  }
  if (part == nullptr) return;
  __syncthreads();

  // this block's per-channel sum and sum of squares, in a fixed order
  const size_t tile = blockIdx.x;
  const size_t tiles = gridDim.x;
  for (int o = warp; o < NT; o += kWarps) {
    float s = 0.f, q = 0.f;
#pragma unroll
    for (int m = lane; m < kFM; m += 32) {
      const float v = s_out[m * NT + o];
      s += v;
      q += v * v;
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (lane == 0 && o0 + o < n_out) {
      part[((n * tiles + tile) * 2 + 0) * n_out + o0 + o] = s;
      part[((n * tiles + tile) * 2 + 1) * n_out + o0 + o] = q;
    }
  }
}

int fma_tiles(int h, int w, int d) {
  return h * ((w + kFW - 1) / kFW) * ((d + kFD - 1) / kFD);
}

// stats[n, s, o] = sum over tiles of part[n, tile, s, o], tiles taken in a
// fixed order by a fixed tree: deterministic. One block per (n, s * O + o).
__global__ void __launch_bounds__(kThreads)
stats_reduce(const float* __restrict__ part, float* __restrict__ stats, int tiles, int n_out) {
  __shared__ float red[kThreads];
  const int n = blockIdx.x;
  const int so = blockIdx.y;  // s * n_out + o
  const int s = so / n_out, o = so % n_out;
  float acc = 0.f;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    acc += part[((static_cast<size_t>(n) * tiles + t) * 2 + s) * n_out + o];
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[(n * 2 + s) * n_out + o] = red[0];
}

int reduce_stats(const float* part, float* stats, int n, int partials, int n_out,
                 cudaStream_t stream) {
  if (stats == nullptr) return 0;
  stats_reduce<<<dim3(n, 2 * n_out), kThreads, 0, stream>>>(part, stats, partials, n_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, int NT>
int launch_fma(const Input& a, const Input& b, const float* bias, void* y, void* z,
               float* part, float* stats, int n, int n_out, int H, int W, int D,
               cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<NT>();
  cudaError_t err = cudaFuncSetAttribute(
      conv_unit_fma<TI, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + kFW - 1) / kFW;
  const int tiles_d = (D + kFD - 1) / kFD;
  const dim3 grid(fma_tiles(H, W, D), n, (n_out + NT - 1) / NT);
  conv_unit_fma<TI, NT><<<grid, kThreads, smem, stream>>>(
      a, b, bias, static_cast<TI*>(y), static_cast<TI*>(z), part, n_out, H, W, D,
      tiles_w, tiles_d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_stats(part, stats, n, fma_tiles(H, W, D), n_out, stream);
}

template <typename TI, int NT>
int launch_mma(MmaArgs a, float* stats, int n, cudaStream_t stream) {
  Plan p{};
  cudaError_t err = plan_mma<TI, NT>(a.ca, a.cb, n, a.n_out, a.H, a.W, a.D, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.tiles_h = (a.H + kTH - 1) / kTH;
  a.tiles_w = (a.W + kTW - 1) / kTW;
  a.tiles_d = (a.D + kTD - 1) / kTD;
  a.gx = p.gx;
  a.resident = p.resident;
  a.vec = a.D % 8 == 0;  // 16-byte aligned rows of 8 bf16 or 4 f32
  p.kernel<<<dim3(p.gx, p.groups, n), kThreads, p.smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return reduce_stats(a.part, stats, n, p.gx, a.n_out, stream);
}

template <typename TI>
int partials_mma(int n, int ca, int cb, int n_out, int h, int w, int d) {
  Plan p{};
  const cudaError_t err = n_out <= 16 ? plan_mma<TI, 16>(ca, cb, n, n_out, h, w, d, &p)
                                      : plan_mma<TI, 32>(ca, cb, n, n_out, h, w, d, &p);
  return err == cudaSuccess ? p.gx : -static_cast<int>(err);
}

// Output channels per block of the bf16 kernel: the NT that its packed
// weights are laid out for (ops/conv_unit.py `block_outputs`).
int block_outputs(int n_out) { return n_out <= 16 ? 16 : 32; }

}  // namespace

extern "C" {

// Partial sums per volume and channel that the statistics need: the
// wrapper allocates `part` as (n, cu_num_partials, 2, n_out). A negative
// value is a CUDA error.
int cu_num_partials(int n, int ca, int cb, int n_out, int h, int w, int d, int is_bf16,
                    int compute_bf16) {
  if (!compute_bf16) return fma_tiles(h, w, d);
  return is_bf16 ? partials_mma<bf16>(n, ca, cb, n_out, h, w, d)
                 : partials_mma<float>(n, ca, cb, n_out, h, w, d);
}

// xa (n, ca, h, w, d) and optional xb (n, cb, h, w, d): contiguous, f32
// (is_bf16 == 0) or bf16; y and z have that dtype. aff_a / aff_b: (n, 2, c)
// f32 or null. bias: (n_out,) f32 or null. y: (n, n_out, h, w, d); z: like
// xa, or null. part: f32 scratch (n, cu_num_partials, 2, n_out) and stats
// (n, 2, n_out), both null without statistics.
// compute_bf16 != 0: operands rounded to bf16; `packed` holds the weights
// as pack_weights lays them out for nt = block_outputs(n_out) outputs
// per block; wa / wb are not read. compute_bf16 == 0: f32 operands; wa /
// wb: f32, element (o, c, tap) at w[(o * cstride + c) * 27 + tap].
// Launches on `stream`; returns the CUDA error of the launches (0 on
// success).
int cu_forward(const void* xa, const void* wa, int wa_cstride, const void* aff_a, int ca,
               const void* xb, const void* wb, int wb_cstride, const void* aff_b, int cb,
               const void* packed, int nt, const void* bias, void* y, void* z, void* part,
               void* stats, int n, int n_out, int h, int w, int d, int is_bf16,
               int compute_bf16, void* stream) {
  const auto* bi = static_cast<const float*>(bias);
  auto* pa = static_cast<float*>(part);
  auto* st = static_cast<float*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  if (compute_bf16) {
    if (nt != block_outputs(n_out) || packed == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    MmaArgs a{};
    a.xa = xa;
    a.xb = xb;
    a.aff_a = static_cast<const float*>(aff_a);
    a.aff_b = static_cast<const float*>(aff_b);
    a.ca = ca;
    a.cb = xb == nullptr ? 0 : cb;
    a.w = static_cast<const bf16*>(packed);
    a.bias = bi;
    a.y = y;
    a.z = z;
    a.part = pa;
    a.n_out = n_out;
    a.H = h;
    a.W = w;
    a.D = d;
    if (is_bf16) {
      return nt == 16 ? launch_mma<bf16, 16>(a, st, n, s) : launch_mma<bf16, 32>(a, st, n, s);
    }
    return nt == 16 ? launch_mma<float, 16>(a, st, n, s) : launch_mma<float, 32>(a, st, n, s);
  }
  const Input a{xa, static_cast<const float*>(wa), wa_cstride,
                static_cast<const float*>(aff_a), ca};
  const Input b{xb, static_cast<const float*>(wb), wb_cstride,
                static_cast<const float*>(aff_b), cb};
  if (is_bf16) {
    return n_out <= 16 ? launch_fma<bf16, 16>(a, b, bi, y, z, pa, st, n, n_out, h, w, d, s)
                       : launch_fma<bf16, 32>(a, b, bi, y, z, pa, st, n, n_out, h, w, d, s);
  }
  return n_out <= 16 ? launch_fma<float, 16>(a, b, bi, y, z, pa, st, n, n_out, h, w, d, s)
                     : launch_fma<float, 32>(a, b, bi, y, z, pa, st, n, n_out, h, w, d, s);
}

}  // extern "C"
