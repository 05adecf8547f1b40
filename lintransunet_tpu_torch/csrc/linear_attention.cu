// Linear attention, forward and backward, for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Computes, per (batch*head) slice of q, k, v, each (N, d) of a
// (B, H, N, d) tensor:
//
//   K'  = softmax over tokens of K            (per feature)
//   ctx = K'^T V                              (d x d, f32)
//   Q'  = softmax over features of Q / sqrt(d)
//   out = Q' ctx                              (N x d, input dtype)
//
// Replaces the three Pallas TPU kernels of lintransunet_tpu/ops/pallas_attention.py:
// the whole-N `_kernel` (pallas_call at :126) and the token-tiled pair
// `_stats_kernel` + `_out_kernel` (pallas_calls at :206 and :233); and, as
// `lta_fold<T, true>` + `lta_bwd_tokens`, the custom VJP `_bwd` (:260-290,
// XLA einsums on the TPU).
// With s_q the feature softmax of q, s_k the token softmax of k and
// scale = 1/sqrt(d), per slice:
//
//   C  = s_k^T v,  D = (s_q scale)^T g                      (d x d each)
//   dq = s_q * (g C^T scale - rowsum(g C^T scale * s_q))
//   dv = s_k D
//   dk = s_k * (v D^T - R),  R_i = colsum_N((v D^T) * s_k)_i = sum_e D_ie C_ie
//
// The last identity (sum_n s_k[n,i] v[n,e] = C[i,e]) removes the third
// reduction over N that `_bwd` has. As in `_bwd`, the softmaxes are
// recomputed from q and k, and the forward saves nothing else.
//
// What bounds it on this card: device-memory bytes, and at the model's
// sizes (a few MB a call) latency. A call reads q, k and v once and writes
// out once; it does O(N d^2) FLOPs, a few per byte, far below the ~295 per
// byte where the H100's tensor cores become the limit. The design keeps to
// two launches a call and one pass over the data each:
//
// * Layouts. Every tensor comes with its (batch, head, token) element
//   strides and a feature stride of 1, so the kernels read the heads in
//   place from a (B, N, H*d) projection (the model's layout) as well as
//   from a contiguous (B, H, N, d) tensor, and write out or dq/dk/dv in
//   the layout they are given. d is 2, 4 or a multiple of 8 up to 32: a
//   token's head segment is whole 16-byte pieces (64 bytes at d = 32 in
//   bf16), or one narrow piece of 4 or 8 bytes (d = 2 or 4 in bf16, d = 2
//   in f32), which every load and store of it moves alone. Features past d
//   are zeros in the fold's tiles and in the token kernels' registers; they
//   drop out of the feature softmax of q (weight 0), so they enter neither
//   the context nor a gradient, and they are never stored.
// * `lta_fold` (one launch). The grid is sized to the card: about
//   kFoldBlocksPerSm blocks per SM shared out over the slices, each block a
//   contiguous range of 32-token tiles dealt to its four warps. A warp
//   stages its tiles by `cp.async` (16 bytes a lane, or a narrow head row
//   and zeros to 16; double-buffered, ragged tokens and padded features
//   zero-filled) and folds each into a
//   running per-feature max, sum and 32 x 32 product in registers,
//   rescaling by the max as it rises (the flash-attention fold). In bf16
//   the tile's K^T comes straight from `ldmatrix.trans` in the A-fragment
//   layout of `mma.sync` m16n8k16, the max and exp run on those registers,
//   and exp(k - m)^T v runs on the tensor cores; f32 keeps an FMA path.
//   The backward folds (s_q scale)^T g beside it (no rescale). The four
//   warps merge in shared memory and the block writes one partial.
// * The merge, in the same launch: every block takes a ticket (atomicAdd
//   after a __threadfence); the last block of a slice merges its slice's
//   partials in split order, so two calls give the same bits (no float
//   atomics), and resets the ticket for the next call. It writes the
//   slice's state: ctx/s (forward), or M, 1/S, R, C/S and D (backward), as
//   f32 matrices or, in bf16, pre-packed `mma.sync` B fragments (hi and lo
//   bf16 halves) in the order the token kernel's lanes read them.
// * `lta_out` / `lta_bwd_tokens` (the second launch, under programmatic
//   dependent launch: it loads its first tokens while the fold finishes).
//   A warp takes 16-token tiles; each lane loads 16 bytes of features
//   8c..8c+7 of rows g and g+8 (g = lane / 4, c = lane % 4; at d = 2 or 4
//   lane c = 0 loads the d features alone and the others none),
//   which is exactly an A fragment once the 32 features are permuted onto
//   the k slots (pi below) and the output columns onto the n slots (sigma),
//   so the feature softmax is a 4-lane reduction, every product is
//   `mma.sync` from registers, and every store is 16 bytes.
//
// Precision: an f32 value that enters a bf16 product (exp(k - m), s_q, s_k,
// q', ctx, C, D) is split into a bf16 hi and a bf16 lo part and both are
// multiplied (hi*hi + hi*lo + lo*hi), so the products carry ~16 bits; the
// MMAs cost nothing at these sizes. Inputs are f32 or bf16; statistics and
// sums are f32; outputs have the input dtype.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using ltu::cp_async16_zfill;
using ltu::kFullMask;
using ltu::ldsm_x4_t;
using ltu::mma_bf16_16816;
using ltu::pack_bf16x2;
using ltu::swz;
using bf16 = __nv_bfloat16;

constexpr int kMaxD = 32;           // MAX_D in ops/linear_attention.py
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kFoldTile = 32;       // tokens per warp tile in lta_fold
constexpr int kRowTile = 16;        // tokens per warp tile in the token kernels
constexpr int kMaxSplits = 64;      // fold blocks per slice, at most
constexpr int kFoldBlocksPerSm = 1;   // 2 was 5-7% slower over the model's calls (PERF.md)
constexpr int kTokenBlocksPerSm = 4;  // 2 was 10% slower, 8 the same
constexpr int kPitch = 36;          // floats per row of an f32 32-column matrix in shared memory
constexpr int kVec = 3 * kMaxD;     // backward state: M, 1/S, R

// Floats per block partial: m, s, C (and D), and per slice state.
template <bool kBwd>
__host__ __device__ constexpr int part_floats() { return 2 * kMaxD + (kBwd ? 2 : 1) * kMaxD * kMaxD; }
template <bool kBwd>
__host__ __device__ constexpr int state_floats() { return kBwd ? kVec + 3 * kMaxD * kMaxD : kMaxD * kMaxD; }

struct Strides {
  long long b, h, n;  // elements between batches, heads, tokens
};

struct Args {
  const void* in[4];  // q, k, v (, g)
  void* out[3];       // out, or dq, dk, dv
  Strides in_s[4], out_s[3];
  float* partials;    // [bh][splits][part_floats]
  float* state;       // [bh][state_floats]
  unsigned* tickets;  // [bh], zero between calls
  int heads, n, d, splits;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* slice(const void* base, Strides s, int bh, int heads) {
  return static_cast<const T*>(base) + (bh / heads) * s.b + (bh % heads) * s.h;
}

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }

__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ unsigned pack_lo(float a, float b) {
  return pack_bf16x2(bf16_rest(a), bf16_rest(b));
}
__device__ __forceinline__ float2 unpack(unsigned w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// ---- the fold: thread layout -------------------------------------------
//
// In a warp's 32-token tile, lane (g, c) holds 4 features x 8 tokens:
// feature 16 mt + 8 fh + g at f4 = 2 mt + fh, token 16 ks + 8 th + 2 c + e at
// t8 = 4 ks + 2 th + e: the A fragments of the tile's transpose for
// m-tiles mt and k-steps ks. Its accumulator acc[mt][j][2 fh + e] holds row
// 16 mt + 8 fh + g, column 8 j + 2 c + e of the 32 x 32 product.

__device__ __forceinline__ int f4_feature(int f4, int g) { return 16 * (f4 >> 1) + 8 * (f4 & 1) + g; }
__device__ __forceinline__ int t8_token(int t8, int c) {
  return 16 * (t8 >> 2) + 8 * ((t8 >> 1) & 1) + 2 * c + (t8 & 1);
}

template <typename T>
struct Tile;

// bf16: 32 rows of 4 16-byte chunks, swizzled for conflict-free ldmatrix.
template <>
struct Tile<bf16> {
  static constexpr int kChunks = 4;
  static constexpr int kElems = kFoldTile * kChunks * 8;
  __device__ static int at(int r, int c) { return swz(r, c, kChunks); }
};

// f32: 32 rows of 32 floats at a pitch of 36: the lanes' column reads hit
// 32 different banks.
template <>
struct Tile<float> {
  static constexpr int kChunks = 8;
  static constexpr int kElems = kFoldTile * kPitch;
  __device__ static int at(int r, int c) { return r * kPitch + c * 4; }
};

// A narrow head row (4 or 8 bytes) into the first bytes of a 16-byte chunk
// by one `cp.async` of its own size (zeros if !valid), and zeros into the
// rest of the chunk by a plain store. `gmem` is aligned to the row's size.
__device__ __forceinline__ void stage_narrow(void* smem, const void* gmem, bool valid,
                                             int bytes) {
  const unsigned s = ltu::smem_addr(smem);
  auto* z = static_cast<unsigned char*>(smem);
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(valid ? 8 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
                 "r"(valid ? 4 : 0)
                 : "memory");
    *reinterpret_cast<unsigned*>(z + 4) = 0u;
  }
  *reinterpret_cast<uint2*>(z + 8) = make_uint2(0u, 0u);
}

// Stage tokens t0..t0+31 of a slice (features 0..d-1) into `tile`; tokens
// at or past n and features past d read as zeros. 16 bytes a lane,
// neighbouring lanes on neighbouring bytes of a token; a narrow row goes
// into its row's first chunk, and a chunk past the row is stored as zeros.
template <typename T>
__device__ __forceinline__ void stage_tile(T* tile, const T* src, long long sn, int t0, int n,
                                           int d, int lane) {
  constexpr int kPer = 16 / sizeof(T);
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int chunks = row_bytes / 16;  // whole chunks of the row; the tail is narrow
#pragma unroll
  for (int idx = lane; idx < kFoldTile * Tile<T>::kChunks; idx += 32) {
    const int r = idx / Tile<T>::kChunks, c = idx % Tile<T>::kChunks;
    const bool ok = t0 + r < n;
    T* dst = tile + Tile<T>::at(r, c);
    const T* p = ok ? src + (t0 + r) * sn + c * kPer : src;
    if (c < chunks) {
      cp_async16_zfill(dst, p, ok);
    } else if (c == chunks && row_bytes % 16) {
      stage_narrow(dst, p, ok, row_bytes % 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The lane's 4 x 8 values of a staged tile (thread layout above).
__device__ __forceinline__ void read_tile(const bf16* tile, float (&x)[4][8], int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned a[4];
      ldsm_x4_t(a, tile + swz(16 * ks + (lane & 7) + ((lane >> 4) << 3),
                              2 * mt + ((lane >> 3) & 1), Tile<bf16>::kChunks));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 v = unpack(a[r]);
        x[2 * mt + (r & 1)][4 * ks + 2 * (r >> 1)] = v.x;
        x[2 * mt + (r & 1)][4 * ks + 2 * (r >> 1) + 1] = v.y;
      }
    }
  }
}

__device__ __forceinline__ void read_tile(const float* tile, float (&x)[4][8], int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int f4 = 0; f4 < 4; ++f4) {
#pragma unroll
    for (int t8 = 0; t8 < 8; ++t8) x[f4][t8] = tile[t8_token(t8, c) * kPitch + f4_feature(f4, g)];
  }
}

// acc += x^T B for the lane's x (4 features x 8 tokens of the tile) and the
// staged tile B (tokens x 32 columns). bf16: x as hi + lo A fragments, B by
// ldmatrix.trans, mma.sync. f32: x written back over `xt` (the tile it was
// read from), then FMA.
__device__ __forceinline__ void fold_product(bf16*, const bf16* bt, const float (&x)[4][8],
                                             float (&acc)[2][4][4], int lane) {
  unsigned hi[2][2][4], lo[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* p = &x[2 * mt + (r & 1)][4 * ks + 2 * (r >> 1)];
        hi[mt][ks][r] = pack_bf16x2(p[0], p[1]);
        lo[mt][ks][r] = pack_lo(p[0], p[1]);
      }
    }
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int pp = 0; pp < 2; ++pp) {
      unsigned b[4];
      ldsm_x4_t(b, bt + swz(16 * ks + (lane & 15), 2 * pp + (lane >> 4), Tile<bf16>::kChunks));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16_16816(acc[mt][2 * pp], hi[mt][ks], b[0], b[1]);
        mma_bf16_16816(acc[mt][2 * pp], lo[mt][ks], b[0], b[1]);
        mma_bf16_16816(acc[mt][2 * pp + 1], hi[mt][ks], b[2], b[3]);
        mma_bf16_16816(acc[mt][2 * pp + 1], lo[mt][ks], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void fold_product(float* xt, const float* bt, const float (&x)[4][8],
                                             float (&acc)[2][4][4], int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int f4 = 0; f4 < 4; ++f4) {
#pragma unroll
    for (int t8 = 0; t8 < 8; ++t8) xt[t8_token(t8, c) * kPitch + f4_feature(f4, g)] = x[f4][t8];
  }
  __syncwarp();
#pragma unroll 4
  for (int t = 0; t < kFoldTile; ++t) {
    float p[4];
#pragma unroll
    for (int f4 = 0; f4 < 4; ++f4) p[f4] = xt[t * kPitch + f4_feature(f4, g)];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = *reinterpret_cast<const float2*>(bt + t * kPitch + 8 * j + 2 * c);
#pragma unroll
      for (int f4 = 0; f4 < 4; ++f4) {
        acc[f4 >> 1][j][2 * (f4 & 1)] += p[f4] * v.x;
        acc[f4 >> 1][j][2 * (f4 & 1) + 1] += p[f4] * v.y;
      }
    }
  }
}

// Fold a staged K, V tile (tokens t0..) into the running max m, sum s and
// acc = sum exp(k - m)^T v, rescaling by exp(m_old - m_new) as the max rises.
template <typename T>
__device__ __forceinline__ void fold_kv(T* kt, const T* vt, int t0, int n, float (&m)[4],
                                        float (&s)[4], float (&acc)[2][4][4], int lane) {
  const int c = lane & 3;
  float x[4][8];
  read_tile(kt, x, lane);
#pragma unroll
  for (int t8 = 0; t8 < 8; ++t8) {
    if (t0 + t8_token(t8, c) >= n) {
#pragma unroll
      for (int f4 = 0; f4 < 4; ++f4) x[f4][t8] = -INFINITY;
    }
  }
#pragma unroll
  for (int f4 = 0; f4 < 4; ++f4) {
    float tmax = x[f4][0];
#pragma unroll
    for (int t8 = 1; t8 < 8; ++t8) tmax = fmaxf(tmax, x[f4][t8]);
    tmax = fmaxf(tmax, __shfl_xor_sync(kFullMask, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFullMask, tmax, 2));
    const float mn = fmaxf(m[f4], tmax);  // finite: every tile has a token
    const float alpha = expf(m[f4] - mn);  // 0 on the first tile
    m[f4] = mn;
    float sum = 0.f;
#pragma unroll
    for (int t8 = 0; t8 < 8; ++t8) {
      x[f4][t8] = expf(x[f4][t8] - mn);
      sum += x[f4][t8];
    }
    s[f4] = s[f4] * alpha + sum;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[f4 >> 1][j][2 * (f4 & 1)] *= alpha;
      acc[f4 >> 1][j][2 * (f4 & 1) + 1] *= alpha;
    }
  }
  fold_product(kt, vt, x, acc, lane);
}

// acc += (s_q scale)^T g for a staged Q, G tile: the feature softmax of each
// token is a reduction over the lane's 4 features and the 8 lanes of its c.
template <typename T>
__device__ __forceinline__ void fold_qg(T* qt, const T* gt, int d, float scale,
                                        float (&acc)[2][4][4], int lane) {
  const int g = lane >> 2;
  float x[4][8];
  read_tile(qt, x, lane);
#pragma unroll
  for (int f4 = 0; f4 < 4; ++f4) {
    if (f4_feature(f4, g) >= d) {
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8) x[f4][t8] = -INFINITY;
    }
  }
#pragma unroll
  for (int t8 = 0; t8 < 8; ++t8) {
    float mx = fmaxf(fmaxf(x[0][t8], x[1][t8]), fmaxf(x[2][t8], x[3][t8]));
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int f4 = 0; f4 < 4; ++f4) {
      x[f4][t8] = expf(x[f4][t8] - mx);
      sum += x[f4][t8];
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
    const float r = scale / sum;
#pragma unroll
    for (int f4 = 0; f4 < 4; ++f4) x[f4][t8] *= r;
  }
  fold_product(qt, gt, x, acc, lane);
}

// ---- the merge ---------------------------------------------------------

// acc (thread layout) into a [32][kPitch] shared matrix, each value times
// its row's factor.
__device__ __forceinline__ void put_acc(float* w, const float (&acc)[2][4][4],
                                        const float (&fac)[4], int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int f4 = 0; f4 < 4; ++f4) {
    const int i = f4_feature(f4, g);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float2*>(w + i * kPitch + 8 * j + 2 * c) =
          make_float2(acc[f4 >> 1][j][2 * (f4 & 1)] * fac[f4],
                      acc[f4 >> 1][j][2 * (f4 & 1) + 1] * fac[f4]);
    }
  }
}

// Thread tid's 8 entries (row tid / 4, columns 8 (tid % 4)..) summed over the
// warps' matrices in warp order, stored to `dst` (32 x 32, row-major).
__device__ __forceinline__ void sum_warps(float* dst, const float* red, int tid) {
  const int i = tid >> 2, e0 = (tid & 3) * 8;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float4 x = *reinterpret_cast<const float4*>(red + (w * kMaxD + i) * kPitch + e0);
    const float4 y = *reinterpret_cast<const float4*>(red + (w * kMaxD + i) * kPitch + e0 + 4);
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    b.x += y.x; b.y += y.y; b.z += y.z; b.w += y.w;
  }
  *reinterpret_cast<float4*>(dst + i * kMaxD + e0) = a;
  *reinterpret_cast<float4*>(dst + i * kMaxD + e0 + 4) = b;
}

// Pack W (32 x 32 in shared memory at kPitch; W(r, c) = w[c][r] if `trans`)
// as the B fragments of mma.sync m16n8k16 for the token kernels' lanes:
// lane (g, c) register r = 8 ks + 2 j + bi holds rows pi^-1(16 ks + 2 c +
// 8 bi + {0, 1}) = 8 c + 4 ks + 2 bi + {0, 1} of column sigma(8 j + g) =
// 8 (g / 2) + 2 j + g % 2. Written as [hi, lo][4 uint4][32 lanes]; needs
// all kThreads threads.
__device__ __forceinline__ void pack_b(uint4* dst, const float* w, bool trans, int tid) {
  const int lane = tid & 31, q = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  unsigned hi[4], lo[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = 4 * q + u;
    const int row = 8 * c + 4 * (r >> 3) + 2 * (r & 1);
    const int col = 8 * (g >> 1) + 2 * ((r >> 1) & 3) + (g & 1);
    const float x0 = trans ? w[col * kPitch + row] : w[row * kPitch + col];
    const float x1 = trans ? w[col * kPitch + row + 1] : w[(row + 1) * kPitch + col];
    hi[u] = pack_bf16x2(x0, x1);
    lo[u] = pack_lo(x0, x1);
  }
  dst[q * 32 + lane] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  dst[(4 + q) * 32 + lane] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

// W (shared, kPitch) to `dst` as a row-major 32 x 32 f32 matrix.
__device__ __forceinline__ void put_f32(float* dst, const float* w, int tid) {
  for (int idx = tid; idx < kMaxD * kMaxD; idx += kThreads) {
    dst[idx] = w[(idx >> 5) * kPitch + (idx & 31)];
  }
}

// The last block of a slice: merge the slice's `splits` partials in split
// order and write its state.
template <typename T, bool kBwd>
__device__ void merge_slice(const Args& a, int bh, float* sm) {
  constexpr int kPart = part_floats<kBwd>();
  const int tid = threadIdx.x;
  const float* parts = a.partials + static_cast<size_t>(bh) * a.splits * kPart;
  float* fac = sm;                           // [kMaxSplits][32]
  float* vec = fac + kMaxSplits * kMaxD;     // M, 1/S, R
  float* wc = vec + kVec;                    // [32][kPitch]: C / S (forward: ctx / s)
  float* wd = wc + kMaxD * kPitch;           // [32][kPitch]: D
  float* grp = wd + kMaxD * kPitch;          // [kWarps][32]
  {
    // warp w takes splits w, w + kWarps, ..., lane = feature: all its loads
    // in flight at once
    constexpr int kPer = kMaxSplits / kWarps;
    const int f = tid & 31, w = tid >> 5;
    float mj[kPer], sj[kPer];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = w + kWarps * u;
      mj[u] = j < a.splits ? __ldcg(parts + j * kPart + f) : -INFINITY;
      sj[u] = j < a.splits ? __ldcg(parts + j * kPart + kMaxD + f) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) m = fmaxf(m, mj[u]);
    grp[w * kMaxD + f] = m;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kWarps; ++v) m = fmaxf(m, grp[v * kMaxD + f]);
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = w + kWarps * u;
      const float fj = mj[u] == -INFINITY ? 0.f : expf(mj[u] - m);
      if (j < a.splits) fac[j * kMaxD + f] = fj;
      s += sj[u] * fj;
    }
    __syncthreads();
    grp[w * kMaxD + f] = s;
    __syncthreads();
    if (tid < kMaxD) {
      s = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) s += grp[v * kMaxD + tid];
      vec[tid] = m;
      vec[kMaxD + tid] = 1.f / s;
    }
  }
  __syncthreads();
  {
    const int i = tid >> 2, e0 = (tid & 3) * 8;
    float cs[8] = {}, ds[8] = {};
#pragma unroll 8
    for (int j = 0; j < a.splits; ++j) {
      const float f = fac[j * kMaxD + i];
      const float* p = parts + j * kPart + 2 * kMaxD + i * kMaxD + e0;
      const float4 c0 = __ldcg(reinterpret_cast<const float4*>(p));
      const float4 c1 = __ldcg(reinterpret_cast<const float4*>(p + 4));
      cs[0] += f * c0.x; cs[1] += f * c0.y; cs[2] += f * c0.z; cs[3] += f * c0.w;
      cs[4] += f * c1.x; cs[5] += f * c1.y; cs[6] += f * c1.z; cs[7] += f * c1.w;
      if constexpr (kBwd) {
        const float4 d0 = __ldcg(reinterpret_cast<const float4*>(p + kMaxD * kMaxD));
        const float4 d1 = __ldcg(reinterpret_cast<const float4*>(p + kMaxD * kMaxD + 4));
        ds[0] += d0.x; ds[1] += d0.y; ds[2] += d0.z; ds[3] += d0.w;
        ds[4] += d1.x; ds[5] += d1.y; ds[6] += d1.z; ds[7] += d1.w;
      }
    }
    const float inv = vec[kMaxD + i];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wc[i * kPitch + e0 + e] = cs[e] * inv;
      wd[i * kPitch + e0 + e] = ds[e];
    }
  }
  __syncthreads();
  float* st = a.state + static_cast<size_t>(bh) * state_floats<kBwd>();
  if constexpr (kBwd) {
    if (tid < kMaxD) {
      float r = 0.f;
      for (int e = 0; e < kMaxD; ++e) r += wd[tid * kPitch + e] * wc[tid * kPitch + e];
      vec[2 * kMaxD + tid] = r;
    }
    __syncthreads();
    if (tid < kVec) st[tid] = vec[tid];
    float* mats = st + kVec;
    if constexpr (sizeof(T) == 2) {
      auto* u = reinterpret_cast<uint4*>(mats);
      pack_b(u, wc, true, tid);         // C^T: dq' = g C^T
      pack_b(u + 256, wd, true, tid);   // D^T: dk' = v D^T
      pack_b(u + 512, wd, false, tid);  // D:   dv = s_k D
    } else {
      put_f32(mats, wc, tid);
      put_f32(mats + kMaxD * kMaxD, wd, tid);
    }
  } else if constexpr (sizeof(T) == 2) {
    pack_b(reinterpret_cast<uint4*>(st), wc, false, tid);
  } else {
    put_f32(st, wc, tid);
  }
  if (tid == 0) a.tickets[bh] = 0;
}

// ---- kernel 1: the fold, the block merge and the slice merge -------------

template <typename T, bool kBwd>
constexpr int fold_smem_bytes() {
  constexpr int tiles = kWarps * 2 * (kBwd ? 4 : 2) * Tile<T>::kElems * sizeof(T);
  constexpr int block = (kWarps * kMaxD * kPitch + 2 * kWarps * kMaxD + 4) * 4;
  constexpr int slice = (kMaxSplits * kMaxD + kVec + 2 * kMaxD * kPitch + kWarps * kMaxD) * 4;
  return tiles > block ? (tiles > slice ? tiles : slice) : (block > slice ? block : slice);
}

template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads) lta_fold(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTensors = kBwd ? 4 : 2;  // K, V (, Q, G)
  constexpr int kPart = part_floats<kBwd>();
  pdl_trigger();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y, split = blockIdx.x;
  const int n = a.n;
  const int n_tiles = (n + kFoldTile - 1) / kFoldTile;
  const int t_lo = static_cast<int>(static_cast<long long>(split) * n_tiles / a.splits);
  const int t_hi = static_cast<int>(static_cast<long long>(split + 1) * n_tiles / a.splits);

  const T* src[kTensors];
  long long sn[kTensors];
  const int order[4] = {1, 2, 0, 3};  // a.in is q, k, v, g
#pragma unroll
  for (int x = 0; x < kTensors; ++x) {
    src[x] = slice<T>(a.in[order[x]], a.in_s[order[x]], bh, a.heads);
    sn[x] = a.in_s[order[x]].n;
  }
  T* tiles = reinterpret_cast<T*>(smem) + warp * 2 * kTensors * Tile<T>::kElems;
  auto issue = [&](int tile, int slot) {
#pragma unroll
    for (int x = 0; x < kTensors; ++x) {
      stage_tile<T>(tiles + (slot * kTensors + x) * Tile<T>::kElems, src[x], sn[x],
                    tile * kFoldTile, n, a.d, lane);
    }
    ltu::cp_async_commit();
  };

  float m[4], s[4], acc[2][4][4], accd[2][4][4];
#pragma unroll
  for (int f4 = 0; f4 < 4; ++f4) {
    m[f4] = -INFINITY;
    s[f4] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][j][r] = accd[mt][j][r] = 0.f;

  int tile = t_lo + warp;
  if (tile < t_hi) issue(tile, 0);
  for (int it = 0; tile < t_hi; ++it, tile += kWarps) {
    const int stg = it & 1;
    if (tile + kWarps < t_hi) {
      issue(tile + kWarps, stg ^ 1);
      ltu::cp_async_wait<1>();
    } else {
      ltu::cp_async_wait<0>();
    }
    __syncwarp();
    T* t = tiles + stg * kTensors * Tile<T>::kElems;
    fold_kv<T>(t, t + Tile<T>::kElems, tile * kFoldTile, n, m, s, acc, lane);
    if constexpr (kBwd) {
      fold_qg<T>(t + 2 * Tile<T>::kElems, t + 3 * Tile<T>::kElems, a.d, a.scale, accd, lane);
    }
    __syncwarp();
  }

  // the block's four warps: one partial, rescaled to the block's max
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][32][kPitch]
  float* wm = red + kWarps * kMaxD * kPitch;    // [kWarps][32]
  float* ws = wm + kWarps * kMaxD;              // [kWarps][32]
  int* last = reinterpret_cast<int*>(ws + kWarps * kMaxD);
#pragma unroll
  for (int f4 = 0; f4 < 4; ++f4) {
    s[f4] += __shfl_xor_sync(kFullMask, s[f4], 1);
    s[f4] += __shfl_xor_sync(kFullMask, s[f4], 2);
    if (c == 0) {
      wm[warp * kMaxD + f4_feature(f4, g)] = m[f4];
      ws[warp * kMaxD + f4_feature(f4, g)] = s[f4];
    }
  }
  __syncthreads();
  float fac[4];
#pragma unroll
  for (int f4 = 0; f4 < 4; ++f4) {
    float big = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, wm[w * kMaxD + f4_feature(f4, g)]);
    fac[f4] = m[f4] == -INFINITY ? 0.f : expf(m[f4] - big);
  }
  put_acc(red + warp * kMaxD * kPitch, acc, fac, lane);
  __syncthreads();
  float* part = a.partials + (static_cast<size_t>(bh) * a.splits + split) * kPart;
  sum_warps(part + 2 * kMaxD, red, tid);
  if (tid < kMaxD) {
    float big = -INFINITY, sum = 0.f;
    for (int w = 0; w < kWarps; ++w) big = fmaxf(big, wm[w * kMaxD + tid]);
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * kMaxD + tid];
      if (mw != -INFINITY) sum += ws[w * kMaxD + tid] * expf(mw - big);
    }
    part[tid] = big;
    part[kMaxD + tid] = sum;
  }
  if constexpr (kBwd) {
    const float one[4] = {1.f, 1.f, 1.f, 1.f};
    __syncthreads();
    put_acc(red + warp * kMaxD * kPitch, accd, one, lane);
    __syncthreads();
    sum_warps(part + 2 * kMaxD + kMaxD * kMaxD, red, tid);
  }

  // the ticket: the slice's last block merges
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(a.tickets + bh, 1u) == static_cast<unsigned>(a.splits - 1);
  __syncthreads();
  if (!*last) return;
  __threadfence();
  merge_slice<T, kBwd>(a, bh, reinterpret_cast<float*>(smem));
}

// ---- kernel 2: the token kernels -----------------------------------------
//
// Lane (g, c) of a warp's 16-token tile holds x[r][jj] = feature 8 c + jj of
// token row g + 8 r. As an A fragment of m16n8k16 it stands for k slot
// pi(8 c + jj) = 16 (jj / 4) + 8 ((jj / 2) % 2) + 2 c + jj % 2, and the
// accumulator of n slot 8 j + 2 c + h stands for column sigma = 8 c + 2 j + h:
// products come out in the same layout as they go in.
//
// kW is the features a lane with 8 c < d holds: 8, or d itself for a narrow
// head (d = 2 or 4: lane c = 0 alone, one 4-, 8- or 16-byte access a row);
// the rest of its 8 are zeros. kW is a template parameter, one kernel
// instance per width: a width read per lane at run time gave wrong bf16
// outputs on the H100 (NaN at d = 32; the cause was not isolated).

template <typename T, int kW>
__device__ __forceinline__ void load_rows(const T* base, long long sn, int t0, int n, bool fok,
                                          float (&x)[2][8], int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + g + 8 * r;
    const bool ok = fok && t < n;
    const T* p = base + t * sn + 8 * c;
    if constexpr (sizeof(T) == 2) {
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kW == 8) {
        if (ok) u = *reinterpret_cast<const uint4*>(p);
      } else if constexpr (kW == 4) {
        if (ok) {
          const uint2 h = *reinterpret_cast<const uint2*>(p);
          u.x = h.x;
          u.y = h.y;
        }
      } else {
        if (ok) u.x = *reinterpret_cast<const unsigned*>(p);
      }
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = unpack(w[i]);
        x[r][2 * i] = v.x;
        x[r][2 * i + 1] = v.y;
      }
    } else {
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f), v = u;
      if constexpr (kW == 2) {
        if (ok) {
          const float2 h = *reinterpret_cast<const float2*>(p);
          u.x = h.x;
          u.y = h.y;
        }
      } else {
        if (ok) u = *reinterpret_cast<const float4*>(p);
        if (kW == 8 && ok) v = *reinterpret_cast<const float4*>(p + 4);
      }
      x[r][0] = u.x; x[r][1] = u.y; x[r][2] = u.z; x[r][3] = u.w;
      x[r][4] = v.x; x[r][5] = v.y; x[r][6] = v.z; x[r][7] = v.w;
    }
  }
}

template <typename T, int kW>
__device__ __forceinline__ void store_rows(T* base, long long sn, int t0, int n, bool fok,
                                           const float (&y)[2][8], int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + g + 8 * r;
    if (!fok || t >= n) continue;
    T* p = base + t * sn + 8 * c;
    if constexpr (sizeof(T) == 2) {
      if constexpr (kW == 8) {
        *reinterpret_cast<uint4*>(p) =
            make_uint4(pack_bf16x2(y[r][0], y[r][1]), pack_bf16x2(y[r][2], y[r][3]),
                       pack_bf16x2(y[r][4], y[r][5]), pack_bf16x2(y[r][6], y[r][7]));
      } else if constexpr (kW == 4) {
        *reinterpret_cast<uint2*>(p) =
            make_uint2(pack_bf16x2(y[r][0], y[r][1]), pack_bf16x2(y[r][2], y[r][3]));
      } else {
        *reinterpret_cast<unsigned*>(p) = pack_bf16x2(y[r][0], y[r][1]);
      }
    } else if constexpr (kW == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(y[r][0], y[r][1]);
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(y[r][0], y[r][1], y[r][2], y[r][3]);
      if constexpr (kW == 8) {
        *reinterpret_cast<float4*>(p + 4) = make_float4(y[r][4], y[r][5], y[r][6], y[r][7]);
      }
    }
  }
}

// The feature softmax of each row, times `scale`; padded features (lanes
// with !fok, and features kW.. of a lane) give 0.
template <int kW>
__device__ __forceinline__ void softmax_rows(float (&x)[2][8], bool fok, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fok && i < kW ? x[r][i] : -INFINITY);
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[r][i] = fok && i < kW ? expf(x[r][i] - mx) : 0.f;
      sum += x[r][i];
    }
    sum += __shfl_xor_sync(kFullMask, sum, 1);
    sum += __shfl_xor_sync(kFullMask, sum, 2);
    const float k = scale / sum;
#pragma unroll
    for (int i = 0; i < 8; ++i) x[r][i] *= k;
  }
}

// sum over the row's 32 features of x * y (the 4 lanes of a row together)
__device__ __forceinline__ float row_dot(const float (&x)[8], const float (&y)[8]) {
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) t += x[i] * y[i];
  t += __shfl_xor_sync(kFullMask, t, 1);
  return t + __shfl_xor_sync(kFullMask, t, 2);
}

// A packed B operand (pack_b): the lane's 16 hi and 16 lo registers.
struct Frags {
  unsigned hi[16], lo[16];
};

__device__ __forceinline__ void load_frags(Frags& f, const uint4* src, int lane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 h = src[q * 32 + lane], l = src[(4 + q) * 32 + lane];
    f.hi[4 * q] = h.x; f.hi[4 * q + 1] = h.y; f.hi[4 * q + 2] = h.z; f.hi[4 * q + 3] = h.w;
    f.lo[4 * q] = l.x; f.lo[4 * q + 1] = l.y; f.lo[4 * q + 2] = l.z; f.lo[4 * q + 3] = l.w;
  }
}

// y = x W on the tensor cores (x rows g, g + 8; W packed); x's lo half is
// multiplied too unless x is exact in bf16.
__device__ __forceinline__ void product(const float (&x)[2][8], const Frags& w, bool split_x,
                                        float (&y)[2][8]) {
  float d[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int b = 4 * ks;
    const unsigned ah[4] = {pack_bf16x2(x[0][b], x[0][b + 1]), pack_bf16x2(x[1][b], x[1][b + 1]),
                            pack_bf16x2(x[0][b + 2], x[0][b + 3]),
                            pack_bf16x2(x[1][b + 2], x[1][b + 3])};
    const unsigned al[4] = {pack_lo(x[0][b], x[0][b + 1]), pack_lo(x[1][b], x[1][b + 1]),
                            pack_lo(x[0][b + 2], x[0][b + 3]), pack_lo(x[1][b + 2], x[1][b + 3])};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 8 * ks + 2 * j;
      mma_bf16_16816(d[j], ah, w.hi[r], w.hi[r + 1]);
      mma_bf16_16816(d[j], ah, w.lo[r], w.lo[r + 1]);
      if (split_x) mma_bf16_16816(d[j], al, w.hi[r], w.hi[r + 1]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    y[0][2 * j] = d[j][0];
    y[0][2 * j + 1] = d[j][1];
    y[1][2 * j] = d[j][2];
    y[1][2 * j + 1] = d[j][3];
  }
}

// y = x W by FMA (f32): x goes through the warp's [16][kPitch] scratch `xs`;
// W is a [32][kPitch] shared matrix, read transposed if `trans`.
__device__ __forceinline__ void product_f32(const float (&x)[2][8], const float* w, bool trans,
                                            float* xs, float (&y)[2][8], int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* p = xs + (g + 8 * r) * kPitch + 8 * c;
    *reinterpret_cast<float4*>(p) = make_float4(x[r][0], x[r][1], x[r][2], x[r][3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(x[r][4], x[r][5], x[r][6], x[r][7]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) y[r][i] = 0.f;
#pragma unroll 4
  for (int f = 0; f < kMaxD; ++f) {
    const float a0 = xs[g * kPitch + f], a1 = xs[(g + 8) * kPitch + f];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wv = trans ? w[(8 * c + i) * kPitch + f] : w[f * kPitch + 8 * c + i];
      y[0][i] += a0 * wv;
      y[1][i] += a1 * wv;
    }
  }
  __syncwarp();
}

// A 32 x 32 row-major f32 matrix from device memory into shared memory.
__device__ __forceinline__ void get_f32(float* w, const float* src, int tid) {
  for (int idx = tid; idx < kMaxD * kMaxD; idx += kThreads) {
    w[(idx >> 5) * kPitch + (idx & 31)] = src[idx];
  }
}

__device__ __forceinline__ void row_tiles(int n, int& lo, int& hi) {
  const int tiles = (n + kRowTile - 1) / kRowTile;
  lo = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
  hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);
}

// out = softmax_d(q) scale (ctx / s)
template <typename T, int kW>
__global__ void __launch_bounds__(kThreads) lta_out(Args a) {
  constexpr bool kF32 = sizeof(T) == 4;
  __shared__ __align__(16) float sw[kF32 ? kMaxD * kPitch + kWarps * kRowTile * kPitch : 1];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const bool fok = 8 * (lane & 3) < a.d;
  const T* q = slice<T>(a.in[0], a.in_s[0], bh, a.heads);
  T* out = const_cast<T*>(slice<T>(a.out[0], a.out_s[0], bh, a.heads));
  int lo, hi;
  row_tiles(a.n, lo, hi);
  int tile = lo + warp;
  float x[2][8];
  load_rows<T, kW>(q, a.in_s[0].n, tile * kRowTile, a.n, fok && tile < hi, x, lane);
  pdl_wait();  // the fold's state is complete
  const float* st = a.state + static_cast<size_t>(bh) * state_floats<false>();
  Frags w;
  if constexpr (kF32) {
    get_f32(sw, st, tid);
    __syncthreads();
  } else {
    load_frags(w, reinterpret_cast<const uint4*>(st), lane);
  }
  for (; tile < hi; tile += kWarps) {
    softmax_rows<kW>(x, fok, a.scale);
    float y[2][8];
    if constexpr (kF32) {
      product_f32(x, sw, false, sw + kMaxD * kPitch + warp * kRowTile * kPitch, y, lane);
    } else {
      product(x, w, true, y);
    }
    store_rows<T, kW>(out, a.out_s[0].n, tile * kRowTile, a.n, fok, y, lane);
    if (tile + kWarps < hi) {
      load_rows<T, kW>(q, a.in_s[0].n, (tile + kWarps) * kRowTile, a.n, fok, x, lane);
    }
  }
}

// dq, dk, dv of each token from the slice's M, 1/S, R, C and D
template <typename T, int kW>
__global__ void __launch_bounds__(kThreads) lta_bwd_tokens(Args a) {
  constexpr bool kF32 = sizeof(T) == 4;
  // bf16: the three packed operands (C^T, D^T, D); f32: C and D, then the
  // warps' row scratch
  constexpr int kFloats = kF32 ? 2 * kMaxD * kPitch + kWarps * kRowTile * kPitch
                               : 3 * kMaxD * kMaxD;
  __shared__ __align__(16) float sw[kFloats];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, c = lane & 3;
  const bool fok = 8 * c < a.d;
  const T* in[4];
  T* out[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) in[i] = slice<T>(a.in[i], a.in_s[i], bh, a.heads);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = const_cast<T*>(slice<T>(a.out[i], a.out_s[i], bh, a.heads));
  int lo, hi;
  row_tiles(a.n, lo, hi);
  int tile = lo + warp;
  float xq[2][8], xk[2][8], xv[2][8], xg[2][8];
  auto load = [&](int t) {
    const bool ok = fok && t < hi;
    load_rows<T, kW>(in[0], a.in_s[0].n, t * kRowTile, a.n, ok, xq, lane);
    load_rows<T, kW>(in[1], a.in_s[1].n, t * kRowTile, a.n, ok, xk, lane);
    load_rows<T, kW>(in[2], a.in_s[2].n, t * kRowTile, a.n, ok, xv, lane);
    load_rows<T, kW>(in[3], a.in_s[3].n, t * kRowTile, a.n, ok, xg, lane);
  };
  load(tile);
  pdl_wait();  // the fold's state is complete
  const float* st = a.state + static_cast<size_t>(bh) * state_floats<true>();
  float mk[8], isk[8], rk[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = fok && i < kW ? 8 * c + i : 0;
    mk[i] = st[f];
    isk[i] = st[kMaxD + f];
    rk[i] = st[2 * kMaxD + f];
  }
  if constexpr (kF32) {
    get_f32(sw, st + kVec, tid);
    get_f32(sw + kMaxD * kPitch, st + kVec + kMaxD * kMaxD, tid);
  } else {
    const auto* src = reinterpret_cast<const uint4*>(st + kVec);
    auto* dst = reinterpret_cast<uint4*>(sw);
    for (int i = tid; i < 3 * kMaxD * kMaxD / 4; i += kThreads) dst[i] = src[i];
  }
  __syncthreads();
  float* xs = kF32 ? sw + 2 * kMaxD * kPitch + warp * kRowTile * kPitch : nullptr;
  for (; tile < hi; tile += kWarps) {
    softmax_rows<kW>(xq, fok, 1.f);  // s_q
    float sk[2][8], y[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sk[r][i] = fok && i < kW ? expf(xk[r][i] - mk[i]) * isk[i] : 0.f;
      }
    // dq = s_q (g C^T scale - rowsum(g C^T scale s_q))
    if constexpr (kF32) {
      product_f32(xg, sw, true, xs, y, lane);
    } else {
      Frags w;
      load_frags(w, reinterpret_cast<const uint4*>(sw), lane);
      product(xg, w, false, y);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) y[r][i] *= a.scale;
      const float t = row_dot(y[r], xq[r]);
#pragma unroll
      for (int i = 0; i < 8; ++i) y[r][i] = xq[r][i] * (y[r][i] - t);
    }
    store_rows<T, kW>(out[0], a.out_s[0].n, tile * kRowTile, a.n, fok, y, lane);
    // dk = s_k (v D^T - R)
    if constexpr (kF32) {
      product_f32(xv, sw + kMaxD * kPitch, true, xs, y, lane);
    } else {
      Frags w;
      load_frags(w, reinterpret_cast<const uint4*>(sw) + 256, lane);
      product(xv, w, false, y);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) y[r][i] = sk[r][i] * (y[r][i] - rk[i]);
    store_rows<T, kW>(out[1], a.out_s[1].n, tile * kRowTile, a.n, fok, y, lane);
    // dv = s_k D
    if constexpr (kF32) {
      product_f32(sk, sw + kMaxD * kPitch, false, xs, y, lane);
    } else {
      Frags w;
      load_frags(w, reinterpret_cast<const uint4*>(sw) + 512, lane);
      product(sk, w, true, y);
    }
    store_rows<T, kW>(out[2], a.out_s[2].n, tile * kRowTile, a.n, fok, y, lane);
    if (tile + kWarps < hi) load(tile + kWarps);
  }
}

// ---- launches ------------------------------------------------------------

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return dev < 64 && count[dev] > 0 ? count[dev] : 132;
}

// Fold blocks per slice: about kFoldBlocksPerSm per SM over the slices, at
// least one tile each, at most kMaxSplits.
int fold_splits(int bh, int n) {
  const int tiles = (n + kFoldTile - 1) / kFoldTile;
  int s = (kFoldBlocksPerSm * sm_count() + bh - 1) / bh;
  s = s < kMaxSplits ? s : kMaxSplits;
  s = s < tiles ? s : tiles;
  return s > 0 ? s : 1;
}

// Token-kernel blocks per slice: about kTokenBlocksPerSm per SM over the
// slices, at least a tile per warp.
int token_splits(int bh, int n) {
  const int tiles = (n + kRowTile - 1) / kRowTile;
  const int per_warp = (tiles + kWarps - 1) / kWarps;
  const int s = (kTokenBlocksPerSm * sm_count() + bh - 1) / bh;
  return s < per_warp ? s : per_warp;
}

// The token kernel for lanes of kW features.
template <typename T, bool kBwd, int kW>
cudaError_t launch_tokens(const cudaLaunchConfig_t& cfg, const Args& a) {
  if constexpr (kBwd) {
    return cudaLaunchKernelEx(&cfg, lta_bwd_tokens<T, kW>, a);
  } else {
    return cudaLaunchKernelEx(&cfg, lta_out<T, kW>, a);
  }
}

template <typename T, bool kBwd>
int launch(Args a, int bh, cudaStream_t stream) {
  a.splits = fold_splits(bh, a.n);
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(a.d)));
  a.partials = a.state + static_cast<size_t>(bh) * state_floats<kBwd>();
  constexpr int smem = fold_smem_bytes<T, kBwd>();
  static bool attributed[64] = {};  // per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !attributed[dev]) {
    cudaError_t err = cudaFuncSetAttribute(lta_fold<T, kBwd>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attributed[dev] = true;
  }
  lta_fold<T, kBwd><<<dim3(a.splits, bh), kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(token_splits(bh, a.n), bh);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = a.d == 2 ? launch_tokens<T, kBwd, 2>(cfg, a)
                 : (a.d == 4 ? launch_tokens<T, kBwd, 4>(cfg, a) : launch_tokens<T, kBwd, 8>(cfg, a));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f32 scratch of one call: the slices' state, then the fold blocks' partials.
long long lta_scratch_floats(int bh, int n, int backward) {
  const long long splits = fold_splits(bh, n);
  if (backward) return bh * (state_floats<true>() + splits * part_floats<true>());
  return bh * (state_floats<false>() + splits * part_floats<false>());
}

// One call, forward or backward, in two arrays of 64-bit integers:
//   `call`: [0] the cudaStream_t, [1] tickets (bh unsigned ints, zero, left
//   zero), [2] scratch (lta_scratch_floats(bh, n, backward) floats), then
//   the tensors' data pointers: q, k, v, out (forward) or q, k, v, g, dq,
//   dk, dv (backward; g is the output's gradient);
//   `plan`: [0] backward, [1] is_bf16 (else f32), [2] bh, [3] heads, [4] n,
//   [5] d, then each tensor's (batch, head, token) element strides, in the
//   order of the pointers.
// Every tensor is (B, H, N, d) with d = 2, 4 or a multiple of 8 up to 32,
// feature stride 1, and rows aligned to min(16, d * element size) bytes. Two launches on the stream, the token kernel
// under programmatic dependent launch; returns the first CUDA error, or 0.
int lta_call(const long long* call, const long long* plan) {
  const bool bwd = plan[0] != 0;
  const int bh = static_cast<int>(plan[2]);
  const int tensors = bwd ? 7 : 4, inputs = bwd ? 4 : 3;
  const long long* ptrs = call + 3;
  const long long* strides = plan + 6;
  Args a = {};
  for (int i = 0; i < tensors; ++i) {
    const Strides st = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
    if (i < inputs) {
      a.in[i] = reinterpret_cast<const void*>(ptrs[i]);
      a.in_s[i] = st;
    } else {
      a.out[i - inputs] = reinterpret_cast<void*>(ptrs[i]);
      a.out_s[i - inputs] = st;
    }
  }
  a.tickets = reinterpret_cast<unsigned*>(call[1]);
  a.state = reinterpret_cast<float*>(call[2]);
  a.heads = static_cast<int>(plan[3]);
  a.n = static_cast<int>(plan[4]);
  a.d = static_cast<int>(plan[5]);
  auto stream = reinterpret_cast<cudaStream_t>(call[0]);
  if (plan[1]) {
    return bwd ? launch<bf16, true>(a, bh, stream) : launch<bf16, false>(a, bh, stream);
  }
  return bwd ? launch<float, true>(a, bh, stream) : launch<float, false>(a, bh, stream);
}

}  // extern "C"
