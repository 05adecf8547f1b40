// Stack of post-LN linear-attention transformer layers for Hopper
// (sm_90a), bound with ctypes. Eval only.
//
// Per layer l, on tokens x (B, N, C) with n_heads heads of d_k = 32:
//
//   q, k, v = x Wq + bq, x Wk + bk, x Wv + bv
//   K' = softmax over tokens of k (per feature), ctx_h = K'_h^T v_h
//   Q' = softmax over each head's features of q, / sqrt(d_k)
//   x1 = LN1(x + (Q' ctx) Wo + bo)                    (eps 1e-6)
//   x  = LN2(x1 + GELU(x1 W1 + b1) W2 + b2)           (exact erf GELU)
//
// Weights come as the JAX package's stacked layout (stack_layer_params):
// A (L, C, 6C) = [Wq | Wk | Wv | Wo | W1], w2 (L, 2C, C), both in the token
// dtype, and vecs (L, 16, 2C) f32 rows [bq, bk, bv, bo, b1, b2, ln1 scale,
// ln1 bias, ln2 scale, ln2 bias]. Products take operands in the token
// dtype and sum in f32; residuals, softmaxes and LayerNorms are f32; the
// token buffer is stored in the token dtype after every layer.
//
// Replaces the Pallas TPU kernel `_make_kernel` of
// lintransunet_tpu/ops/pallas_layer.py (pallas_call at :281, via
// `fused_transformer_stack`). The TPU kernel kept the whole token buffer
// in VMEM across layers; 28,704 x 128 tokens do not fit in a block's 227 KB
// of shared memory, so here each layer is three launches:
//
// * `stack_kv_partial`, per 32-token tile (16 in f32): the k/v
//   projections, the tile's per-feature max m and sum s of exp(k - m), and
//   the per-head partial ctx = exp(k - m)^T v. k and v never reach device
//   memory.
// * `stack_ctx_combine`, per feature: merges the tiles' partials with
//   max-rescaling in a fixed order (no atomics, deterministic) into
//   ctx / s, as the linear-attention kernel's combine does.
// * `stack_apply_layer`, per token tile: q projection, per-head softmax,
//   Q' ctx, o projection, residual, LN1, FFN with GELU, residual, LN2,
//   store.
//   It updates the tile in place, so one buffer serves every layer.
//
// What bounds it on this card: operations. A layer is ~16 C^2 FLOP per
// token against ~4 C bytes of token traffic (C = 128 or 256). The products
// are block GEMMs from shared memory, WMMA 16x16x16 in bf16 and FMA in
// f32, with each weight matrix streamed through shared memory in K chunks
// for every token tile. That re-reads the weights from L2 once per tile;
// wgmma, TMA and weight residency across tiles are later work.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using ltu::from_f32;
using ltu::round_to;
using ltu::to_f32;
using ltu::warp_max;
using ltu::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDk = 32;          // features per head: one per lane
constexpr int kNP = 256;         // output columns per GEMM pass
constexpr int kPadT = 8;         // row padding of token-dtype operands
constexpr int kPadF = 4;         // row padding of f32 GEMM outputs
constexpr int kLdW = kNP + kPadT;
constexpr float kLnEps = 1e-6f;

template <typename T>
struct Tile;
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kTokens = 32;  // tokens per block
  static constexpr int kChunk = 32;   // K rows of a staged weight chunk
};
template <>
struct Tile<float> {
  static constexpr int kTokens = 16;
  static constexpr int kChunk = 16;
};

// Shared-memory plan of one block, in bytes, for width c.
template <typename T>
struct Plan {
  static constexpr int TN = Tile<T>::kTokens;
  size_t a, g, x1, w, ctx, total;
  int ld_a, ld_g;
  __host__ __device__ Plan(int c, bool apply) {
    ld_a = 2 * c + kPadT;
    ld_g = 2 * c + kPadF;
    a = 0;
    g = ltu::align_up(a + sizeof(T) * TN * ld_a, 128);
    w = ltu::align_up(g + sizeof(float) * TN * ld_g, 128);
    x1 = ltu::align_up(w + sizeof(T) * Tile<T>::kChunk * kLdW, 128);
    ctx = ltu::align_up(x1 + (apply ? sizeof(float) * TN * c : 0), 128);
    total = ctx + (apply ? sizeof(T) * c * kDk : 0);
  }
};

// s_w[r][j] = w[k0 + r][n0 + j] for r < kChunk, j < np, in 16-byte copies;
// between barriers, so s_w's previous readers are done and its new values
// are seen by all.
template <typename T>
__device__ void stage_weights(const T* __restrict__ w, int ldw, int k0, int n0, int np,
                              T* s_w) {
  constexpr int kVec = 16 / sizeof(T);
  const int units = np / kVec;
  __syncthreads();
  for (int u = threadIdx.x; u < Tile<T>::kChunk * units; u += kThreads) {
    const int r = u / units, cu = u - r * units;
    *reinterpret_cast<uint4*>(s_w + r * kLdW + cu * kVec) = *reinterpret_cast<const uint4*>(
        w + static_cast<size_t>(k0 + r) * ldw + n0 + cu * kVec);
  }
  __syncthreads();
}

// s_out[r][n0 + j] = sum_k s_in[r][k] w[k][j] for the block's TN rows,
// k < K, j < nout. w: device memory in T with row stride ldw, offset to its
// first column; it is staged through s_w in chunks of kChunk rows. Ends
// with a barrier, so s_out is ready and s_in may be overwritten.
template <typename T>
__device__ void block_gemm(const T* s_in, int ld_in, int K, const T* __restrict__ w,
                           int ldw, int nout, T* s_w, float* s_out, int ld_out) {
  using namespace nvcuda;
  constexpr int TN = Tile<T>::kTokens;
  constexpr int KC = Tile<T>::kChunk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  for (int n0 = 0; n0 < nout; n0 += kNP) {
    const int np = min(kNP, nout - n0);
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      constexpr int MT = TN / 16;
      const int ntiles = MT * (np / 16);
      constexpr int kPerWarp = MT * (kNP / 16) / kWarps;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kPerWarp];
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) wmma::fill_fragment(acc[i], 0.f);
      for (int k0 = 0; k0 < K; k0 += KC) {
        stage_weights<T>(w, ldw, k0, n0, np, s_w);
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16) {
#pragma unroll
          for (int i = 0; i < kPerWarp; ++i) {
            const int id = warp + kWarps * i;
            if (id < ntiles) {
              const int mt = id % MT, nt = id / MT;
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
              wmma::load_matrix_sync(a, s_in + mt * 16 * ld_in + k0 + kk, ld_in);
              wmma::load_matrix_sync(b, s_w + kk * kLdW + nt * 16, kLdW);
              wmma::mma_sync(acc[i], a, b, acc[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int id = warp + kWarps * i;
        if (id < ntiles) {
          const int mt = id % MT, nt = id / MT;
          wmma::store_matrix_sync(s_out + mt * 16 * ld_out + n0 + nt * 16, acc[i], ld_out,
                                  wmma::mem_row_major);
        }
      }
    } else {
      // thread -> column n0 + col, rows [rg * rpt, rg * rpt + rpt)
      const int groups = kThreads / np;
      const int col = tid % np;
      const int rg = tid / np;
      const int rpt = TN / groups;
      float acc[TN];
#pragma unroll
      for (int r = 0; r < TN; ++r) acc[r] = 0.f;
      for (int k0 = 0; k0 < K; k0 += KC) {
        stage_weights<T>(w, ldw, k0, n0, np, s_w);
        for (int kk = 0; kk < KC; ++kk) {
          const float wv = to_f32(s_w[kk * kLdW + col]);
#pragma unroll
          for (int r = 0; r < TN; ++r) {
            if (r < rpt) acc[r] += to_f32(s_in[(rg * rpt + r) * ld_in + k0 + kk]) * wv;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < TN; ++r) {
        if (r < rpt) s_out[(rg * rpt + r) * ld_out + n0 + col] = acc[r];
      }
    }
  }
  __syncthreads();
}

// Load the block's token tile (zeros past n) into s_a as T; also as f32
// into x32 if given.
template <typename T>
__device__ void load_tile(const T* __restrict__ x, T* s_a, int ld_a, float* x32,
                          int t0, int count, int c) {
  constexpr int TN = Tile<T>::kTokens;
  for (int idx = threadIdx.x; idx < TN * c; idx += kThreads) {
    const int r = idx / c, f = idx - r * c;
    const T v = r < count ? x[static_cast<size_t>(t0 + r) * c + f] : from_f32<T>(0.f);
    s_a[r * ld_a + f] = v;
    if (x32 != nullptr) x32[r * c + f] = to_f32(v);
  }
}

// One block per (token tile, batch): the tile's K-softmax partials and ctx.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stack_kv_partial(const T* __restrict__ x, const T* __restrict__ A, const float* __restrict__ vec,
           float* __restrict__ part_m, float* __restrict__ part_s,
           float* __restrict__ part_ctx, int n, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TN = Tile<T>::kTokens;
  const Plan<T> plan(c, false);
  T* s_a = reinterpret_cast<T*>(smem + plan.a);
  float* s_g = reinterpret_cast<float*>(smem + plan.g);
  T* s_w = reinterpret_cast<T*>(smem + plan.w);
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int t0 = tile * TN;
  const int count = min(TN, n - t0);
  const int ld_g = plan.ld_g;

  load_tile<T>(x + static_cast<size_t>(b) * n * c, s_a, plan.ld_a, nullptr, t0, count, c);
  __syncthreads();
  // s_g[:, 0:c] = x Wk, s_g[:, c:2c] = x Wv
  block_gemm<T>(s_a, plan.ld_a, c, A + c, 6 * c, 2 * c, s_w, s_g, ld_g);

  const size_t part = static_cast<size_t>(b) * tiles + tile;
  // per feature: the tile's max and sum of exp; exp(k - m) replaces k,
  // rounded to T as the ctx product's operand
  for (int f = threadIdx.x; f < c; f += kThreads) {
    const float bk = vec[1 * 2 * c + f];
    float m = -INFINITY;
    for (int r = 0; r < count; ++r) m = fmaxf(m, s_g[r * ld_g + f] + bk);
    float s = 0.f;
    for (int r = 0; r < TN; ++r) {
      const float e = r < count ? expf(s_g[r * ld_g + f] + bk - m) : 0.f;
      s += e;
      s_g[r * ld_g + f] = round_to<T>(e);
    }
    part_m[part * c + f] = m;
    part_s[part * c + f] = s;
  }
  for (int idx = threadIdx.x; idx < TN * c; idx += kThreads) {
    const int r = idx / c, f = idx - r * c;
    float* p = s_g + r * ld_g + c + f;
    *p = r < count ? round_to<T>(*p + vec[2 * 2 * c + f]) : 0.f;
  }
  __syncthreads();
  // ctx[i][j] = sum_r e[r][i] v[r][head(i) * 32 + j]
  for (int p = threadIdx.x; p < c * kDk; p += kThreads) {
    const int i = p / kDk, j = p % kDk;
    const int vcol = c + (i / kDk) * kDk + j;
    float acc = 0.f;
    for (int r = 0; r < count; ++r) acc += s_g[r * ld_g + i] * s_g[r * ld_g + vcol];
    part_ctx[(part * c + i) * kDk + j] = acc;
  }
}

// One block per (feature i, batch): ctxn[b][i][:] = ctx / s over all tiles,
// merged with max-rescaling in a fixed order.
__global__ void __launch_bounds__(kThreads)
stack_ctx_combine(const float* __restrict__ part_m, const float* __restrict__ part_s,
            const float* __restrict__ part_ctx, float* __restrict__ ctxn, int tiles, int c) {
  __shared__ float red[kWarps][kDk];
  __shared__ float big_m, total_s;
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t base = static_cast<size_t>(b) * tiles;

  float m = -INFINITY;
  for (int t = tid; t < tiles; t += kThreads) m = fmaxf(m, part_m[(base + t) * c + i]);
  m = warp_max(m);
  if (lane == 0) red[warp][0] = m;
  __syncthreads();
  if (tid == 0) {
    float mm = red[0][0];
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, red[w][0]);
    big_m = mm;
  }
  __syncthreads();
  const float M = big_m;

  float s = 0.f;
  for (int t = tid; t < tiles; t += kThreads) {
    s += part_s[(base + t) * c + i] * expf(part_m[(base + t) * c + i] - M);
  }
  s = warp_sum(s);
  __syncthreads();  // red is reused
  if (lane == 0) red[warp][0] = s;
  __syncthreads();
  if (tid == 0) {
    float ss = 0.f;
    for (int w = 0; w < kWarps; ++w) ss += red[w][0];
    total_s = ss;
  }
  __syncthreads();

  float acc = 0.f;
  for (int t = warp; t < tiles; t += kWarps) {
    acc += part_ctx[((base + t) * c + i) * kDk + lane] * expf(part_m[(base + t) * c + i] - M);
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps; ++w) total += red[w][lane];
    ctxn[(static_cast<size_t>(b) * c + i) * kDk + lane] = total / total_s;
  }
}

// Post-LN over one row held by a warp: lane owns features lane + 32 j.
// v: the residual sums (c / 32 of them); writes the normalised row.
__device__ __forceinline__ void layer_norm_row(float* v, int per_lane, int c,
                                               const float* scale, const float* shift) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int j = 0; j < per_lane; ++j) s += v[j];
  const float mean = warp_sum(s) / c;
  float q = 0.f;
  for (int j = 0; j < per_lane; ++j) q += (v[j] - mean) * (v[j] - mean);
  const float rs = rsqrtf(warp_sum(q) / c + kLnEps);
  for (int j = 0; j < per_lane; ++j) {
    const int f = lane + 32 * j;
    v[j] = (v[j] - mean) * rs * scale[f] + shift[f];
  }
}

// One block per (token tile, batch): the rest of the layer, in place.
template <typename T>
__global__ void __launch_bounds__(kThreads)
stack_apply_layer(const T* x_in, T* x_out, const T* __restrict__ A, const T* __restrict__ w2,
            const float* __restrict__ vec, const float* __restrict__ ctxn, int n, int c,
            int heads, float inv_sqrt_dk) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TN = Tile<T>::kTokens;
  constexpr int kMaxPerLane = 256 / 32;
  const Plan<T> plan(c, true);
  T* s_a = reinterpret_cast<T*>(smem + plan.a);
  float* s_g = reinterpret_cast<float*>(smem + plan.g);
  T* s_w = reinterpret_cast<T*>(smem + plan.w);
  float* s_x1 = reinterpret_cast<float*>(smem + plan.x1);
  T* s_ctx = reinterpret_cast<T*>(smem + plan.ctx);
  const int ld_a = plan.ld_a, ld_g = plan.ld_g;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TN;
  const int count = min(TN, n - t0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int per_lane = c / 32;
  const int c2 = 2 * c;

  load_tile<T>(x_in + static_cast<size_t>(b) * n * c, s_a, ld_a, s_x1, t0, count, c);
  for (int idx = tid; idx < c * kDk; idx += kThreads) {
    s_ctx[idx] = from_f32<T>(ctxn[static_cast<size_t>(b) * c * kDk + idx]);
  }
  __syncthreads();

  // q = x Wq; per (token, head): feature softmax / sqrt(d_k), then Q' ctx
  block_gemm<T>(s_a, ld_a, c, A, 6 * c, c, s_w, s_g, ld_g);
  for (int p = warp; p < TN * heads; p += kWarps) {
    const int r = p / heads, h = p % heads;
    const int f = h * kDk + lane;
    const float qv = s_g[r * ld_g + f] + vec[f];
    const float e = expf(qv - warp_max(qv));
    const float qs = round_to<T>(e / warp_sum(e) * inv_sqrt_dk);
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kDk; ++i) {
      acc += __shfl_sync(ltu::kFullMask, qs, i) * to_f32(s_ctx[(h * kDk + i) * kDk + lane]);
    }
    s_a[r * ld_a + f] = from_f32<T>(acc);
  }
  __syncthreads();

  // x1 = LN1(x + attn Wo + bo)
  block_gemm<T>(s_a, ld_a, c, A + 3 * c, 6 * c, c, s_w, s_g, ld_g);
  for (int r = warp; r < TN; r += kWarps) {
    float v[kMaxPerLane];
    for (int j = 0; j < per_lane; ++j) {
      const int f = lane + 32 * j;
      v[j] = s_x1[r * c + f] + s_g[r * ld_g + f] + vec[3 * c2 + f];
    }
    layer_norm_row(v, per_lane, c, vec + 6 * c2, vec + 7 * c2);
    for (int j = 0; j < per_lane; ++j) {
      const int f = lane + 32 * j;
      s_x1[r * c + f] = v[j];
      s_a[r * ld_a + f] = from_f32<T>(v[j]);
    }
  }
  __syncthreads();

  // h = GELU(x1 W1 + b1)
  block_gemm<T>(s_a, ld_a, c, A + 4 * c, 6 * c, c2, s_w, s_g, ld_g);
  for (int idx = tid; idx < TN * c2; idx += kThreads) {
    const int r = idx / c2, f = idx - r * c2;
    const float hv = s_g[r * ld_g + f] + vec[4 * c2 + f];
    s_a[r * ld_a + f] = from_f32<T>(0.5f * hv * (1.f + erff(hv * 0.70710678118654752f)));
  }
  __syncthreads();

  // x = LN2(x1 + h W2 + b2), stored in T
  block_gemm<T>(s_a, ld_a, c2, w2, c, c, s_w, s_g, ld_g);
  T* out = x_out + static_cast<size_t>(b) * n * c;
  for (int r = warp; r < TN; r += kWarps) {
    float v[kMaxPerLane];
    for (int j = 0; j < per_lane; ++j) {
      const int f = lane + 32 * j;
      v[j] = s_x1[r * c + f] + s_g[r * ld_g + f] + vec[5 * c2 + f];
    }
    layer_norm_row(v, per_lane, c, vec + 8 * c2, vec + 9 * c2);
    if (r < count) {
      for (int j = 0; j < per_lane; ++j) {
        out[static_cast<size_t>(t0 + r) * c + lane + 32 * j] = from_f32<T>(v[j]);
      }
    }
  }
}

int num_tiles(int n, int is_bf16) {
  const int tn = is_bf16 ? Tile<__nv_bfloat16>::kTokens : Tile<float>::kTokens;
  return (n + tn - 1) / tn;
}

template <typename T>
int launch(const void* x, void* out, const void* A, const void* w2, const float* vecs,
           float* part_m, float* part_s, float* part_ctx, float* ctxn, int batch, int n,
           int c, int heads, int layers, cudaStream_t stream) {
  const size_t kv_smem = Plan<T>(c, false).total;
  const size_t apply_smem = Plan<T>(c, true).total;
  cudaError_t err = cudaFuncSetAttribute(
      stack_kv_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(stack_apply_layer<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(apply_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = num_tiles(n, std::is_same<T, __nv_bfloat16>::value);
  const float inv_sqrt_dk = static_cast<float>(1.0 / sqrt(static_cast<double>(kDk)));
  const dim3 grid(tiles, batch);
  for (int l = 0; l < layers; ++l) {
    const T* a_l = static_cast<const T*>(A) + static_cast<size_t>(l) * c * 6 * c;
    const T* w2_l = static_cast<const T*>(w2) + static_cast<size_t>(l) * 2 * c * c;
    const float* vec_l = vecs + static_cast<size_t>(l) * 16 * 2 * c;
    const T* in = l == 0 ? static_cast<const T*>(x) : static_cast<const T*>(out);
    stack_kv_partial<T><<<grid, kThreads, kv_smem, stream>>>(in, a_l, vec_l, part_m, part_s,
                                                       part_ctx, n, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stack_ctx_combine<<<dim3(c, batch), kThreads, 0, stream>>>(part_m, part_s, part_ctx, ctxn,
                                                         tiles, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stack_apply_layer<T><<<grid, kThreads, apply_smem, stream>>>(
        in, static_cast<T*>(out), a_l, w2_l, vec_l, ctxn, n, c, heads, inv_sqrt_dk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// Token tiles per sequence: sizes the wrapper's partial-sum scratch.
int fst_num_tiles(int n, int is_bf16) { return num_tiles(n, is_bf16); }

// x, out: (batch, n, c) contiguous, f32 (is_bf16 == 0) or bf16; out may not
// alias x. A (layers, c, 6c) and w2 (layers, 2c, c) in the token dtype;
// vecs (layers, 16, 2c) f32. c in {32, 64, 128, 256}, c = 32 * heads.
// Scratch (f32): part_m, part_s (batch, tiles, c); part_ctx (batch, tiles,
// c, 32); ctxn (batch, c, 32). Launches 3 kernels per layer on `stream`;
// returns the first CUDA error (0 on success).
int fst_forward(const void* x, void* out, const void* A, const void* w2, const void* vecs,
                void* part_m, void* part_s, void* part_ctx, void* ctxn, int batch, int n,
                int c, int heads, int layers, int is_bf16, void* stream) {
  const auto* v = static_cast<const float*>(vecs);
  auto* pm = static_cast<float*>(part_m);
  auto* ps = static_cast<float*>(part_s);
  auto* pc = static_cast<float*>(part_ctx);
  auto* cn = static_cast<float*>(ctxn);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, out, A, w2, v, pm, ps, pc, cn, batch, n, c, heads, layers, s);
  }
  return launch<float>(x, out, A, w2, v, pm, ps, pc, cn, batch, n, c, heads, layers, s);
}

}  // extern "C"
