// Linear attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Computes, per (batch*head) slice of q, k, v laid out (BH, N, d):
//
//   K'  = softmax over tokens of K            (per feature row)
//   ctx = K'^T V                              (d x d_v, f32)
//   Q'  = softmax over features of Q / sqrt(d)
//   out = Q' ctx                              (N x d_v, input dtype)
//
// Replaces the three Pallas TPU kernels of lintransunet_tpu/ops/pallas_attention.py:
// the whole-N `_kernel` (pallas_call at :126) and the token-tiled pair
// `_stats_kernel` + `_out_kernel` (pallas_calls at :206 and :233).
//
// What bounds it on this card: device-memory bytes. Each call reads q, k
// and v once and writes out once (about 4 N*d values per head) and does
// O(N*d^2) FLOPs, a few FLOPs per byte, far below the ~295 FLOP/byte the
// H100 needs before its arithmetic is the limit. So the design only avoids
// extra passes over N*d data, and keeps enough blocks in flight:
//
// * The TPU needed two forms (whole-N and token-tiled) because 16 MB of
//   VMEM could not hold long token rows. Here one split-N design covers
//   every N: `ctx_partial` gives each block a 128-token range and keeps,
//   per feature row, the range's max m, the rescaled sum s and the
//   rescaled ctx in f32. The split exists because BH is only 4-8 in the
//   model against 132 SMs; splitting N gives hundreds of blocks.
// * `ctx_combine` merges the splits of one slice with max-rescaling and
//   writes ctx/s, one block per slice, in a fixed order: the result is
//   deterministic and needs no atomics.
// * `attn_out` gives one token to one warp with lane = feature (d <= 32):
//   the feature softmax is a warp-shuffle max and sum, and
//   out[e] = sum_i q'[i] * ctx[i][e] reads ctx from shared memory.
// * The ragged tail is masked in the kernels instead of padding K with
//   -1e9 as the TPU kernel does.
//
// Inputs are f32 or bf16; statistics and sums are f32; the output has the
// input dtype. d == d_v <= 32 (checked by the Python wrapper).

#include "common.cuh"

namespace {

using ltu::kFullMask;
using ltu::store;
using ltu::to_f32;
using ltu::warp_max;
using ltu::warp_sum;

constexpr int kMaxD = 32;  // MAX_D in ops/linear_attention.py
constexpr int kSplitTokens = 128;      // tokens per ctx_partial block
constexpr int kPartialThreads = 256;
constexpr int kPartialWarps = kPartialThreads / 32;
constexpr int kOutWarps = 8;
constexpr int kOutTokensPerWarp = 16;
constexpr int kOutTokens = kOutWarps * kOutTokensPerWarp;  // per attn_out block

// One block per (slice, 128-token range): the range's per-feature max m,
// sum s = sum_n exp(k - m) and ctx = sum_n exp(k - m) v.
template <typename T>
__global__ void __launch_bounds__(kPartialThreads)
ctx_partial(const T* __restrict__ k, const T* __restrict__ v,
            float* __restrict__ part_m, float* __restrict__ part_s,
            float* __restrict__ part_ctx, int n, int d) {
  __shared__ float ks[kSplitTokens][kMaxD];  // K tile, then exp(K - m) in place
  __shared__ float vs[kSplitTokens][kMaxD];
  __shared__ float red[kPartialWarps][kMaxD];
  __shared__ float m_s[kMaxD];

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int t0 = split * kSplitTokens;
  const int count = min(kSplitTokens, n - t0);
  const size_t base = (static_cast<size_t>(bh) * n + t0) * d;
  for (int idx = threadIdx.x; idx < count * d; idx += kPartialThreads) {
    const int tk = idx / d, f = idx - tk * d;
    ks[tk][f] = to_f32(k[base + idx]);
    vs[tk][f] = to_f32(v[base + idx]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float mx = -INFINITY;
  if (lane < d) {
    for (int tk = warp; tk < count; tk += kPartialWarps) mx = fmaxf(mx, ks[tk][lane]);
  }
  red[warp][lane] = mx;
  __syncthreads();
  if (threadIdx.x < d) {
    float m = red[0][threadIdx.x];
    for (int w = 1; w < kPartialWarps; ++w) m = fmaxf(m, red[w][threadIdx.x]);
    m_s[threadIdx.x] = m;
  }
  __syncthreads();

  float sum = 0.f;
  if (lane < d) {
    const float m = m_s[lane];
    for (int tk = warp; tk < count; tk += kPartialWarps) {
      const float p = expf(ks[tk][lane] - m);
      ks[tk][lane] = p;
      sum += p;
    }
  }
  red[warp][lane] = sum;
  __syncthreads();

  const size_t part = static_cast<size_t>(bh) * gridDim.y + split;
  if (threadIdx.x < d) {
    float s = 0.f;
    for (int w = 0; w < kPartialWarps; ++w) s += red[w][threadIdx.x];
    part_s[part * d + threadIdx.x] = s;
    part_m[part * d + threadIdx.x] = m_s[threadIdx.x];
  }
  // ctx: thread -> feature row i and four consecutive value columns.
  const int i = threadIdx.x >> 3;
  const int e0 = (threadIdx.x & 7) * 4;
  if (i < d) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int tk = 0; tk < count; ++tk) {
      const float p = ks[tk][i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += p * vs[tk][e0 + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0 + j < d) part_ctx[(part * d + i) * d + e0 + j] = acc[j];
    }
  }
}

// One block per slice: merge the n_split partials with max-rescaling and
// write ctx / s (d x d, f32). Summed in split order: deterministic.
__global__ void ctx_combine(const float* __restrict__ part_m,
                            const float* __restrict__ part_s,
                            const float* __restrict__ part_ctx,
                            float* __restrict__ ctx, int n_split, int d) {
  __shared__ float big_m[kMaxD];
  __shared__ float total_s[kMaxD];
  const int bh = blockIdx.x;
  const float* pm = part_m + static_cast<size_t>(bh) * n_split * d;
  const float* ps = part_s + static_cast<size_t>(bh) * n_split * d;
  const float* pc = part_ctx + static_cast<size_t>(bh) * n_split * d * d;
  const int tid = threadIdx.x;
  if (tid < d) {
    float m = -INFINITY;
    for (int j = 0; j < n_split; ++j) m = fmaxf(m, pm[j * d + tid]);
    float s = 0.f;
    for (int j = 0; j < n_split; ++j) s += ps[j * d + tid] * expf(pm[j * d + tid] - m);
    big_m[tid] = m;
    total_s[tid] = s;
  }
  __syncthreads();
  if (tid < d * d) {
    const int i = tid / d, e = tid - i * d;
    float c = 0.f;
    for (int j = 0; j < n_split; ++j) {
      c += pc[(static_cast<size_t>(j) * d + i) * d + e] * expf(pm[j * d + i] - big_m[i]);
    }
    ctx[(static_cast<size_t>(bh) * d + i) * d + e] = c / total_s[i];
  }
}

// One warp per token, lane = feature: out = softmax_d(q) / sqrt(d) @ ctx.
template <typename T>
__global__ void __launch_bounds__(kOutWarps * 32)
attn_out(const T* __restrict__ q, const float* __restrict__ ctx,
         T* __restrict__ out, int n, int d, float scale) {
  __shared__ float cs[kMaxD][kMaxD];
  const int bh = blockIdx.x;
  for (int idx = threadIdx.x; idx < d * d; idx += kOutWarps * 32) {
    cs[idx / d][idx % d] = ctx[static_cast<size_t>(bh) * d * d + idx];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = lane < d ? lane : 0;
  for (int r = 0; r < kOutTokensPerWarp; ++r) {
    // neighbouring warps take neighbouring tokens; tk is uniform in a warp
    const int tk = blockIdx.y * kOutTokens + r * kOutWarps + warp;
    if (tk >= n) break;
    const size_t row = (static_cast<size_t>(bh) * n + tk) * d;
    const float x = lane < d ? to_f32(q[row + lane]) : -INFINITY;
    const float m = warp_max(x);
    const float p = lane < d ? expf(x - m) : 0.f;
    const float qs = p / warp_sum(p) * scale;
    float acc = 0.f;
    for (int i = 0; i < d; ++i) acc += __shfl_sync(kFullMask, qs, i) * cs[i][col];
    if (lane < d) store(out + row + lane, acc);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part_m, float* part_s, float* part_ctx, float* ctx,
           int bh, int n, int d, cudaStream_t stream) {
  const int n_split = (n + kSplitTokens - 1) / kSplitTokens;
  ctx_partial<T><<<dim3(bh, n_split), kPartialThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), part_m, part_s, part_ctx, n, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int combine_threads = (d * d + 31) / 32 * 32;
  ctx_combine<<<bh, combine_threads, 0, stream>>>(part_m, part_s, part_ctx, ctx, n_split, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  attn_out<T><<<dim3(bh, (n + kOutTokens - 1) / kOutTokens), kOutWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), ctx, static_cast<T*>(out), n, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of token ranges ctx_partial splits N into; sizes the wrapper's scratch.
int lta_num_splits(int n) { return (n + kSplitTokens - 1) / kSplitTokens; }

// q, k, v, out: (bh, n, d) contiguous, f32 (is_bf16 == 0) or bf16.
// Scratch (f32): part_m, part_s (bh, n_split, d); part_ctx (bh, n_split, d, d);
// ctx (bh, d, d). Launches on `stream`; returns cudaGetLastError().
int lta_forward(const void* q, const void* k, const void* v, void* out,
                void* part_m, void* part_s, void* part_ctx, void* ctx,
                int bh, int n, int d, int is_bf16, void* stream) {
  auto* pm = static_cast<float*>(part_m);
  auto* ps = static_cast<float*>(part_s);
  auto* pc = static_cast<float*>(part_ctx);
  auto* c = static_cast<float*>(ctx);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, out, pm, ps, pc, c, bh, n, d, st);
  return launch<float>(q, k, v, out, pm, ps, pc, c, bh, n, d, st);
}

}  // extern "C"
