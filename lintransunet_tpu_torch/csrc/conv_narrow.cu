// Stride-1 3x3x3 convolution with at most 8 outputs for Hopper (sm_90a),
// bound with ctypes.
//
// For x (N, C, H, W, D) bf16, contiguous, a weight (O, C, 3, 3, 3) with
// O <= 8, and an optional bf16 bias (O,):
//
//   y[n, o, h, w, d] = bias[o] + sum over c, kh, kw, kd of
//       w[o, c, kh, kw, kd] * x[n, c, h + kh - 1, w + kw - 1, d + kd - 1]
//
// with x read as 0 outside the volume: `F.conv3d(x, w, bias, 1, 1)` with
// bf16 products summed in f32 and y rounded to bf16 once.
//
// It replaces no TPU kernel: the JAX package left its convolutions to XLA.
// It was added because cuDNN runs these convolutions (the decoders' final
// block, 16 -> 8; the ROI decoder's mask heads, 32-256 -> 2) on the H100
// as an implicit GEMM of its tensor cores between two layout transposes,
// the bias a kernel of its own: 1.9 ms of a flagship window (PERF.md,
// section 6).
//
// What bounds it on this card: bytes. With 8 outputs or fewer a voxel's
// 16-256 input channels are read to make 1-8 values: 2 x 27 x O FLOP a
// voxel and input channel against 2 bytes, under the H100's ~295 FLOP a byte
// for O <= 5. A flagship window's routed calls read and write ~340 MB,
// 0.10 ms at 3.35 TB/s.
//
// Design:
// * Persistent grid, each block walks output tiles of TH x TW (h, w)
//   columns over the whole depth, rounded up to DT tiles of 16 (the
//   model's depths: 16, 32, 64), so a tile needs no halo along d. A stage
//   is one K chunk of 16 input channels of one tile: its (TH + 2) x
//   (TW + 2) halo columns, staged by 16-byte `cp.async` copies (zero
//   filled outside the volume) as pieces of 8 d of one channel, and the
//   chunk's packed weights. Two stages are in flight: the copies of the
//   next (across tiles too) run while the warps multiply the current one.
// * Shared memory: for each halo column and 8-d segment, the 16 channels'
//   pieces side by side (XOR-swizzled by segment so that the copies of a
//   warp land in distinct banks), which `ldmatrix.trans` reads as the
//   A operand (16 d x 16 channels) of `mma.sync` m16n8k16 with no bank
//   conflict.
// * The outputs sit on the narrow side (N = 8, the weights as B); the
//   long side is 16 consecutive d of one (h, w) column. Each warp owns
//   2 x 2 columns at one 16-d tile. A is read at the unshifted d only:
//   each A tile is multiplied by the taps of every kd, and the shift along
//   d is applied to the sums in the epilogue (y[d] = P0[d - 1] + P1[d] +
//   P2[d + 1], P_kd the sum over kh, kw and channels of tap kd's
//   products). With O <= 2 the three kd share one product: its columns
//   are (kd, o) pairs; with O > 2 each kd has its own.
// * Epilogue: the d shift by warp shuffles, and through shared memory at
//   the edges of a warp's 16-d tile; the bias in f32, one rounding to bf16,
//   stores of the real outputs only. Each output is summed by one warp in
//   a fixed order, with no atomics, so a call gives the same bits on every
//   run.
// * Weights: `conv_unit_narrow_pack` lays out each chunk's B fragments
//   (f32 or bf16 weights rounded to bf16) as the lanes read them, padding
//   outputs and channels with zeros; the padding is never stored.
// What still separates it from the bound (PERF.md, section 6): the staging
// of the halo, 2.25 times a tile's own columns, most of it from L2 (a build
// without those copies takes 45-63% of the time), then the multiplies.
// The kernels' names start with `conv_unit_narrow`, the port's prefix for
// its convolution kernels, which keeps them apart from cuDNN's in a trace.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 16;  // input channels a K chunk
constexpr int kMaxOut = 8;

// A tile's (h, w) columns: DT 16-d tiles along d; a warp owns 2 x 2 columns
// of one 16-d tile, so (TH / 2) x (TW / 2) x DT = 8 warps.
__host__ __device__ constexpr int tile_h(int dt) { return dt > 2 ? 2 : 4; }
__host__ __device__ constexpr int tile_w(int dt) { return 32 / (dt * tile_h(dt)); }

template <int DT>
struct Geo {
  static constexpr int TH = tile_h(DT), TW = tile_w(DT), QW = TW / 2;
  static constexpr int HH = TH + 2, WW = TW + 2;     // halo columns
  static constexpr int SEGS = 2 * DT;                // 8-d segments
  static constexpr int COLUMN = SEGS * kKC * 8;      // bf16 a halo column
  static constexpr int X_BYTES = HH * WW * COLUMN * 2;
  static_assert((TH / 2) * (TW / 2) * DT == kWarps, "one 2 x 2 x 16 item a warp");
};

// B fragments a chunk: one per (kh, kw) with the kd in the columns (wide ==
// false, O <= 2) or one per tap (wide)
template <bool WIDE>
__host__ __device__ constexpr int frags() { return WIDE ? 27 : 9; }

template <int DT, bool WIDE>
__host__ __device__ constexpr int stage_bytes() {
  return Geo<DT>::X_BYTES + frags<WIDE>() * 32 * 8;
}

constexpr int kBoundaryFloats = kWarps * 4 * 2 * kMaxOut;  // (warp, column, side, o)

template <int DT, bool WIDE>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * stage_bytes<DT, WIDE>() + kBoundaryFloats * 4;
}

struct Args {
  const bf16* x;          // (n, c, h, w, d)
  const uint2* wp;        // packed weights: (chunks, frags, 32 lanes)
  const bf16* bias;       // (o,) or null
  bf16* y;                // (n, o, h, w, d)
  int n, c, o, h, w, d;
  int chunks, tiles_h, tiles_w;
  int tiles;              // n * tiles_h * tiles_w
};

// Tile t's volume and its first output row and column.
template <int DT>
__device__ __forceinline__ void tile_origin(const Args& a, int t, int& n, int& h0, int& w0) {
  const int per_volume = a.tiles_h * a.tiles_w;
  n = t / per_volume;
  const int r = t - n * per_volume, th = r / a.tiles_w;
  h0 = th * Geo<DT>::TH;
  w0 = (r - th * a.tiles_w) * Geo<DT>::TW;
}

// The element offset, in a halo column, of the 16-byte piece of channel c
// (0..15) at 8-d segment s: segments of 16 pieces, channels XOR-swizzled
// by the segment so that a warp's copies (4-16 segments, 2-8 channels)
// fall in distinct banks; any 8 channels of one segment stay 128
// contiguous bytes, so an `ldmatrix` phase is conflict-free.
__device__ __forceinline__ int piece(int s, int c) { return (s * kKC + (c ^ ((s & 3) << 1))) * 8; }

// Starts the copies of stage (tile t, chunk ch) into `buf`; the weights
// too unless `weights` is false (they are already there).
template <int DT, bool WIDE>
__device__ __forceinline__ void issue(unsigned char* buf, const Args& a, int t, int ch,
                                      bool weights, int tid) {
  using G = Geo<DT>;
  int n, h0, w0;
  tile_origin<DT>(a, t, n, h0, w0);
  const int c0 = ch * kKC, wd = a.w * a.d, hwd = a.h * wd;
  // the chunk's first channel plane; pieces offset from it in 32 bits
  const bf16* plane = a.x + (static_cast<long long>(n) * a.c + c0) * hwd;
  bf16* sx = reinterpret_cast<bf16*>(buf);
  constexpr int kPieces = G::HH * G::WW * G::SEGS * kKC;
#pragma unroll 4
  for (int i = tid; i < kPieces; i += kThreads) {
    const int s = i % G::SEGS;
    const int c = (i / G::SEGS) % kKC;
    const int q = i / (G::SEGS * kKC);
    const int gh = h0 - 1 + q / G::WW, gw = w0 - 1 + q % G::WW;
    const bool valid = c0 + c < a.c && static_cast<unsigned>(gh) < static_cast<unsigned>(a.h) &&
                       static_cast<unsigned>(gw) < static_cast<unsigned>(a.w) && s * 8 < a.d;
    const bf16* src = valid ? plane + static_cast<long long>(c) * hwd + (gh * wd + gw * a.d + s * 8)
                            : a.x;
    ltu::cp_async16_zfill(sx + q * G::COLUMN + piece(s, c), src, valid);
  }
  if (weights) {
    constexpr int kWords = frags<WIDE>() * 32 * 8 / 16;
    const uint4* src = reinterpret_cast<const uint4*>(a.wp + static_cast<size_t>(ch) *
                                                                frags<WIDE>() * 32);
    uint4* dst = reinterpret_cast<uint4*>(buf + G::X_BYTES);
    for (int i = tid; i < kWords; i += kThreads) ltu::cp_async16(dst + i, src + i);
  }
}

// acc[i][k][p] += the stage's products for the warp's column (i, k) of its
// 2 x 2, p = kd (wide) or 0.
template <int DT, bool WIDE, int NP>
__device__ __forceinline__ void multiply(float (&acc)[2][2][NP][4], const unsigned char* buf,
                                         int qh, int qw, int j, int lane) {
  using G = Geo<DT>;
  const bf16* sx = reinterpret_cast<const bf16*>(buf);
  const uint2* sw = reinterpret_cast<const uint2*>(buf + G::X_BYTES);
  // lanes 8m..8m+7 address matrix m: channels (lane & 7) + 8 (m >> 1), d
  // segment 2 j + (m & 1); transposed, they are the A fragment's registers
  const int m = lane >> 3;
  const int lane_off = piece(2 * j + (m & 1), (lane & 7) + ((m >> 1) << 3));
  const bf16* base = sx + (2 * qh * G::WW + 2 * qw) * G::COLUMN + lane_off;
  if constexpr (!WIDE) {
    // every (kh, kw) fragment in registers; each of the 4 x 4 halo columns
    // read once and multiplied for every output column it reaches
    uint2 b[9];
#pragma unroll
    for (int f = 0; f < 9; ++f) b[f] = sw[f * 32 + lane];
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
#pragma unroll
      for (int ww = 0; ww < 4; ++ww) {
        unsigned af[4];
        ltu::ldsm_x4_t(af, base + (hh * G::WW + ww) * G::COLUMN);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int kh = hh - i, kw = ww - k;
            if (kh < 0 || kh > 2 || kw < 0 || kw > 2) continue;
            ltu::mma_bf16_16816(acc[i][k][0], af, b[kh * 3 + kw].x, b[kh * 3 + kw].y);
          }
        }
      }
    }
  } else {
    // one kh at a time: its 9 (kw, kd) fragments in registers, the 2 x 4
    // halo columns it reaches read for it
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
      uint2 b[9];
#pragma unroll
      for (int f = 0; f < 9; ++f) b[f] = sw[(kh * 9 + f) * 32 + lane];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int ww = 0; ww < 4; ++ww) {
          unsigned af[4];
          ltu::ldsm_x4_t(af, base + ((i + kh) * G::WW + ww) * G::COLUMN);
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int kw = ww - k;
            if (kw < 0 || kw > 2) continue;
#pragma unroll
            for (int kd = 0; kd < 3; ++kd) {
              ltu::mma_bf16_16816(acc[i][k][kd], af, b[kw * 3 + kd].x, b[kw * 3 + kd].y);
            }
          }
        }
      }
    }
  }
}

// Row `row` (-1..16) of column pair element e of the accumulator `v` on
// lane src: rows 0-7 sit in registers e, rows 8-15 in 2 + e. `lo` and `hi`
// say whether any lane asks for a row of that half (known at compile time
// once the callers' loops unroll), so a value costs one shuffle where the
// half is the same on every lane. Rows -1 and 16 read as garbage: the
// caller replaces them.
__device__ __forceinline__ float row_of(const float (&v)[4], int e, int row, int src, bool lo,
                                        bool hi) {
  const float a = lo ? __shfl_sync(ltu::kFullMask, v[e], src) : 0.f;
  const float b = hi ? __shfl_sync(ltu::kFullMask, v[2 + e], src) : 0.f;
  return row >= 8 ? b : a;
}

// Sums, bias, rounding and stores of the warp's 2 x 2 columns of tile t.
// Fragment rows are d (16 j + lane / 4 and + 8), columns 2 (lane % 4) + e.
// y[d] = P0[d - 1] + P1[d] + P2[d + 1]; P_kd[r] sits in row r of
// accumulator kd at column o (wide), or of accumulator 0 at column
// 2 kd + o. Rows -1 and 16 come from the neighbouring 16-d tiles' warps
// through `bnd`.
template <int DT, bool WIDE, int NP>
__device__ __forceinline__ void epilogue(const float (&acc)[2][2][NP][4], float* bnd,
                                         const Args& a, int t, int qh, int qw, int j,
                                         int warp, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  int n, h_base, w_base;
  tile_origin<DT>(a, t, n, h_base, w_base);
  h_base += 2 * qh;
  w_base += 2 * qw;
  // the columns this lane stores: o = 2 tq + e (wide) or e on lanes
  // tq == 0 (narrow, whose columns are (kd, o))
  const int o_base = WIDE ? 2 * tq : 0;
  const bool owner = WIDE || tq == 0;

  if constexpr (DT > 1) {
    // rows that the neighbouring tiles' warps need: P2[0] for tile j - 1,
    // P0[15] for tile j + 1
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float(&p0)[4] = acc[c >> 1][c & 1][0];
      const float(&p2)[4] = acc[c >> 1][c & 1][WIDE ? 2 : 0];
      float* slot = bnd + (warp * 4 + c) * 2 * kMaxOut;
      if (g == 0 && (WIDE || tq == 2)) {
        slot[o_base + 0] = p2[0];
        slot[o_base + 1] = p2[1];
      }
      if (g == 7 && (WIDE || tq == 0)) {
        slot[kMaxOut + o_base + 0] = p0[2];
        slot[kMaxOut + o_base + 1] = p0[3];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int h = h_base + (c >> 1), w = w_base + (c & 1);
    float y[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [row g / g + 8][e]
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      const float(&p)[4] = acc[c >> 1][c & 1][WIDE ? kd : 0];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half + kd - 1;  // -1 .. 16
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v;
          if (WIDE && kd == 1) {
            v = p[2 * half + e];  // the lane's own row
          } else {
            // in the narrow product lane tq == kd holds kd's columns
            const int src = ((row & 7) << 2) | (WIDE ? tq : kd);
            v = row_of(p, e, row, src, half == 0 || kd == 0, half == 1 || kd == 2);
          }
          if (row < 0) {
            v = (DT > 1 && j > 0) ? bnd[((warp - 1) * 4 + c) * 2 * kMaxOut + kMaxOut + o_base + e]
                                  : 0.f;
          } else if (row > 15) {
            v = (DT > 1 && j < DT - 1) ? bnd[((warp + 1) * 4 + c) * 2 * kMaxOut + o_base + e]
                                       : 0.f;
          }
          y[half][e] += v;
        }
      }
    }
    if (!owner || h >= a.h || w >= a.w) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = o_base + e;
      if (o >= a.o) continue;
      const float bias = a.bias != nullptr ? __bfloat162float(a.bias[o]) : 0.f;
      bf16* col = a.y + ((static_cast<size_t>(n) * a.o + o) * a.h + h) *
                            static_cast<size_t>(a.w) * a.d +
                  static_cast<size_t>(w) * a.d;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = 16 * j + g + 8 * half;
        if (d < a.d) col[d] = __float2bfloat16(y[half][e] + bias);
      }
    }
  }
}

template <int NP>
__device__ __forceinline__ void zero(float (&acc)[2][2][NP][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][k][p][e] = 0.f;
}

template <int DT, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2) conv_unit_narrow(const Args a) {
  using G = Geo<DT>;
  constexpr int NP = WIDE ? 3 : 1;
  constexpr int kStage = stage_bytes<DT, WIDE>();
  extern __shared__ __align__(128) unsigned char smem[];
  float* bnd = reinterpret_cast<float*>(smem + 2 * kStage);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int j = warp % DT, qi = warp / DT, qh = qi / G::QW, qw = qi % G::QW;

  int t = blockIdx.x;
  if (t >= a.tiles) return;
  int ch = 0, buf = 0;
  issue<DT, WIDE>(smem, a, t, 0, true, tid);
  ltu::cp_async_commit();

  float acc[2][2][NP][4];
  zero(acc);
  for (int stage = 0;; ++stage) {
    int nt = t, nch = ch + 1;
    if (nch == a.chunks) {
      nch = 0;
      nt += gridDim.x;
    }
    const bool more = nt < a.tiles;
    // a single chunk's weights stay in both buffers once copied
    if (more) issue<DT, WIDE>(smem + (buf ^ 1) * kStage, a, nt, nch, a.chunks > 1 || stage < 1,
                              tid);
    ltu::cp_async_commit();
    ltu::cp_async_wait<1>();
    __syncthreads();
    multiply<DT, WIDE, NP>(acc, smem + buf * kStage, qh, qw, j, lane);
    if (ch == a.chunks - 1) {
      epilogue<DT, WIDE, NP>(acc, bnd, a, t, qh, qw, j, warp, lane);
      zero(acc);
    }
    __syncthreads();  // this buffer (and `bnd`) is free for the stage after next
    if (!more) break;
    t = nt;
    ch = nch;
    buf ^= 1;
  }
}

// Packed B fragments: for chunk ch, fragment f and lane (g = lane / 4,
// tq = lane % 4) the words (B[2 tq][g], B[2 tq + 1][g]) and (B[2 tq + 8][g],
// B[2 tq + 9][g]), lower k in the lower half, where B[k][col] is the weight
// of input channel 16 ch + k and, wide, output col at tap f; narrow, output
// col % 2 at tap 3 f + col / 2 (columns 6 and 7 zero). Zero past the
// outputs and channels.
template <typename TW>
__global__ void conv_unit_narrow_pack(const TW* __restrict__ w, uint2* __restrict__ out, int o_n,
                                      int c_n, int nf, int wide, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int lane = i % 32, f = (i / 32) % nf, ch = i / (32 * nf);
  const int g = lane >> 2, tq = lane & 3;
  auto value = [&](int kk, int col) -> float {
    const int c = ch * kKC + kk;
    const int o = wide ? col : col % 2;
    const int tap = wide ? f : 3 * f + col / 2;
    if ((!wide && col >= 6) || o >= o_n || c >= c_n) return 0.f;
    return ltu::to_f32(w[(static_cast<size_t>(o) * c_n + c) * 27 + tap]);
  };
  const __nv_bfloat162 lo = __floats2bfloat162_rn(value(2 * tq, g), value(2 * tq + 1, g));
  const __nv_bfloat162 hi = __floats2bfloat162_rn(value(2 * tq + 8, g), value(2 * tq + 9, g));
  out[i] = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                      *reinterpret_cast<const unsigned*>(&hi));
}

template <int DT, bool WIDE>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto kernel = conv_unit_narrow<DT, WIDE>;
  constexpr int kSmem = smem_bytes<DT, WIDE>();
  // the attribute and the occupancy once per instantiation: a captured
  // call (CUDA graphs) then only launches
  static int grid_per_sm = 0, sms = 0;
  if (grid_per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmem);
    if (err != cudaSuccess) return err;
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess) {
      return err;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid_per_sm = per_sm;
  }
  const int most = sms * grid_per_sm;
  kernel<<<a.tiles < most ? a.tiles : most, kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

template <bool WIDE>
cudaError_t launch_depth(const Args& a, int dt, cudaStream_t s) {
  switch (dt) {
    case 1: return launch<1, WIDE>(a, s);
    case 2: return launch<2, WIDE>(a, s);
    case 4: return launch<4, WIDE>(a, s);
    case 8: return launch<8, WIDE>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

// The 16-d tiles a call's depth takes (a power of two, at most 8), or 0
// where the kernel does not take the depth.
int depth_tiles(int d) {
  if (d <= 0 || d % 8 != 0) return 0;
  int dt = 1;
  while (16 * dt < d) dt *= 2;
  return dt <= 8 ? dt : 0;
}

}  // namespace

extern "C" {

// x: bf16 (n, c, h, w, d), contiguous, 16-byte aligned; weight: (o, c, 3,
// 3, 3) contiguous, bf16 (weight_bf16 != 0) or f32; bias: bf16 (o,) or
// null; packed: scratch of (ceil(c / 16), frags, 32) 8-byte words, frags 9
// (o <= 2) or 27; y: bf16 (n, o, h, w, d). dims: n, c, o, h, w, d. Two
// launches on `stream`, the packing and the convolution; returns the CUDA
// error of the launches (0 on success).
int cn_forward(const void* x, const void* weight, int weight_bf16, void* packed,
               const void* bias, void* y, const long long* dims, void* stream) {
  Args a{};
  a.n = static_cast<int>(dims[0]);
  a.c = static_cast<int>(dims[1]);
  a.o = static_cast<int>(dims[2]);
  a.h = static_cast<int>(dims[3]);
  a.w = static_cast<int>(dims[4]);
  a.d = static_cast<int>(dims[5]);
  const int dt = depth_tiles(a.d);
  if (a.o < 1 || a.o > kMaxOut || a.c < 1 || dt == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int th = tile_h(dt), tw = tile_w(dt);
  a.tiles_h = (a.h + th - 1) / th;
  a.tiles_w = (a.w + tw - 1) / tw;
  const long long tiles = static_cast<long long>(a.n) * a.tiles_h * a.tiles_w;
  if (tiles >= (1LL << 31) || static_cast<long long>(a.h) * a.w * a.d >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.tiles = static_cast<int>(tiles);
  const bool wide = a.o > 2;
  const int nf = wide ? 27 : 9;
  a.chunks = (a.c + kKC - 1) / kKC;
  auto s = static_cast<cudaStream_t>(stream);
  const int total = a.chunks * nf * 32;
  auto* out = static_cast<uint2*>(packed);
  if (weight_bf16) {
    conv_unit_narrow_pack<bf16><<<(total + 255) / 256, 256, 0, s>>>(
        static_cast<const bf16*>(weight), out, a.o, a.c, nf, wide, total);
  } else {
    conv_unit_narrow_pack<float><<<(total + 255) / 256, 256, 0, s>>>(
        static_cast<const float*>(weight), out, a.o, a.c, nf, wide, total);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  a.x = static_cast<const bf16*>(x);
  a.wp = out;
  a.bias = static_cast<const bf16*>(bias);
  a.y = static_cast<bf16*>(y);
  return static_cast<int>(wide ? launch_depth<true>(a, dt, s) : launch_depth<false>(a, dt, s));
}

}  // extern "C"
