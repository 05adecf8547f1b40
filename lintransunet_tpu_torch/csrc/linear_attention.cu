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
//
// The backward (`lta_backward`) replaces the custom VJP `_bwd` of
// pallas_attention.py:260-290 (XLA einsums on the TPU). With s_q the
// feature softmax of q, s_k the token softmax of k and scale = 1/sqrt(d),
// per slice:
//
//   C  = s_k^T v,  D = (s_q scale)^T g                      (d x d each)
//   dq = s_q * (g C^T scale - rowsum(g C^T scale * s_q))
//   dv = s_k D
//   dk = s_k * (v D^T - R),  R_i = colsum_N((v D^T) * s_k)_i = sum_e D_ie C_ie
//
// The last identity (sum_n s_k[n,i] v[n,e] = C[i,e]) removes the third
// reduction over N that `_bwd` has, so the backward is three launches like
// the forward: `bwd_partial` (per 128-token range: the K max and sum, and
// the C and D partials, all f32), `bwd_combine` (fixed-order merge into M,
// S, R, C, D per slice; no atomics) and `bwd_tokens` (a token per warp,
// lane = feature: dq, dk and dv). As in `_bwd`, the softmaxes are
// recomputed from q and k and nothing else is saved by the forward. It
// reads q, k, v and g twice and writes dq, dk and dv once.

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

// ---- backward ----------------------------------------------------------

// Per slice, the combine's result: M, S, R (kMaxD each), then C and D
// (kMaxD x kMaxD each, row-major d x d in the first d*d entries).
constexpr int kStateFloats = 3 * kMaxD + 2 * kMaxD * kMaxD;

// One block per (slice, 128-token range): the range's per-feature K max m,
// sum s = sum_n exp(k - m), C partial = sum_n exp(k - m) v and
// D partial = sum_n (s_q scale) g.
template <typename T>
__global__ void __launch_bounds__(kPartialThreads)
bwd_partial(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, float* __restrict__ part_m,
            float* __restrict__ part_s, float* __restrict__ part_c,
            float* __restrict__ part_d, int n, int d, float scale) {
  __shared__ float as[kSplitTokens][kMaxD];  // K tile -> exp(K - m); then s_q scale
  __shared__ float bs[kSplitTokens][kMaxD];  // V tile; then G tile
  __shared__ float red[kPartialWarps][kMaxD];
  __shared__ float m_s[kMaxD];

  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int t0 = split * kSplitTokens;
  const int count = min(kSplitTokens, n - t0);
  const size_t base = (static_cast<size_t>(bh) * n + t0) * d;
  for (int idx = threadIdx.x; idx < count * d; idx += kPartialThreads) {
    const int tk = idx / d, f = idx - tk * d;
    as[tk][f] = to_f32(k[base + idx]);
    bs[tk][f] = to_f32(v[base + idx]);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float mx = -INFINITY;
  if (lane < d) {
    for (int tk = warp; tk < count; tk += kPartialWarps) mx = fmaxf(mx, as[tk][lane]);
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
      const float p = expf(as[tk][lane] - m);
      as[tk][lane] = p;
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
  // thread -> feature row i and four consecutive value columns
  const int i = threadIdx.x >> 3;
  const int e0 = (threadIdx.x & 7) * 4;
  if (i < d) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int tk = 0; tk < count; ++tk) {
      const float p = as[tk][i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += p * bs[tk][e0 + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0 + j < d) part_c[(part * d + i) * d + e0 + j] = acc[j];
    }
  }
  __syncthreads();  // the C loop's readers are done with as and bs

  // s_q scale and g of the range: a warp per token, lane = feature
  for (int tk = warp; tk < count; tk += kPartialWarps) {
    const size_t row = base + static_cast<size_t>(tk) * d;
    const float x = lane < d ? to_f32(q[row + lane]) : -INFINITY;
    const float m = warp_max(x);
    const float p = lane < d ? expf(x - m) : 0.f;
    const float sq = p / warp_sum(p) * scale;
    if (lane < d) {
      as[tk][lane] = sq;
      bs[tk][lane] = to_f32(g[row + lane]);
    }
  }
  __syncthreads();
  if (i < d) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int tk = 0; tk < count; ++tk) {
      const float p = as[tk][i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += p * bs[tk][e0 + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0 + j < d) part_d[(part * d + i) * d + e0 + j] = acc[j];
    }
  }
}

// One block per slice: merge the partials in split order (deterministic)
// into M, S, C (rescaled and divided by S), D, and R_i = sum_e D_ie C_ie.
__global__ void bwd_combine(const float* __restrict__ part_m, const float* __restrict__ part_s,
                            const float* __restrict__ part_c, const float* __restrict__ part_d,
                            float* __restrict__ state, int n_split, int d) {
  __shared__ float big_m[kMaxD];
  __shared__ float total_s[kMaxD];
  __shared__ float cs[kMaxD][kMaxD + 1];
  __shared__ float ds[kMaxD][kMaxD + 1];
  const int bh = blockIdx.x;
  const float* pm = part_m + static_cast<size_t>(bh) * n_split * d;
  const float* ps = part_s + static_cast<size_t>(bh) * n_split * d;
  const float* pc = part_c + static_cast<size_t>(bh) * n_split * d * d;
  const float* pd = part_d + static_cast<size_t>(bh) * n_split * d * d;
  float* st = state + static_cast<size_t>(bh) * kStateFloats;
  const int tid = threadIdx.x;
  if (tid < d) {
    float m = -INFINITY;
    for (int j = 0; j < n_split; ++j) m = fmaxf(m, pm[j * d + tid]);
    float s = 0.f;
    for (int j = 0; j < n_split; ++j) s += ps[j * d + tid] * expf(pm[j * d + tid] - m);
    big_m[tid] = m;
    total_s[tid] = s;
    st[tid] = m;
    st[kMaxD + tid] = s;
  }
  __syncthreads();
  if (tid < d * d) {
    const int i = tid / d, e = tid - i * d;
    float c = 0.f, dd = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const size_t at = (static_cast<size_t>(j) * d + i) * d + e;
      c += pc[at] * expf(pm[j * d + i] - big_m[i]);
      dd += pd[at];
    }
    c /= total_s[i];
    cs[i][e] = c;
    ds[i][e] = dd;
    st[3 * kMaxD + tid] = c;
    st[3 * kMaxD + kMaxD * kMaxD + tid] = dd;
  }
  __syncthreads();
  if (tid < d) {
    float r = 0.f;
    for (int e = 0; e < d; ++e) r += ds[tid][e] * cs[tid][e];
    st[2 * kMaxD + tid] = r;
  }
}

// One warp per token, lane = feature: dq, dk and dv of the token.
template <typename T>
__global__ void __launch_bounds__(kOutWarps * 32)
bwd_tokens(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ g, const float* __restrict__ state,
           T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int n, int d,
           float scale) {
  __shared__ float ct[kMaxD][kMaxD];  // ct[e][i] = C[i][e]
  __shared__ float dd[kMaxD][kMaxD];  // dd[i][e] = D[i][e]
  __shared__ float dt[kMaxD][kMaxD];  // dt[e][i] = D[i][e]
  __shared__ float mk[kMaxD], sk[kMaxD], rk[kMaxD];
  const int bh = blockIdx.x;
  const float* st = state + static_cast<size_t>(bh) * kStateFloats;
  for (int idx = threadIdx.x; idx < d * d; idx += kOutWarps * 32) {
    const int i = idx / d, e = idx - i * d;
    ct[e][i] = st[3 * kMaxD + idx];
    const float x = st[3 * kMaxD + kMaxD * kMaxD + idx];
    dd[i][e] = x;
    dt[e][i] = x;
  }
  if (threadIdx.x < d) {
    mk[threadIdx.x] = st[threadIdx.x];
    sk[threadIdx.x] = st[kMaxD + threadIdx.x];
    rk[threadIdx.x] = st[2 * kMaxD + threadIdx.x];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool on = lane < d;
  const int col = on ? lane : 0;
  for (int r = 0; r < kOutTokensPerWarp; ++r) {
    const int tk = blockIdx.y * kOutTokens + r * kOutWarps + warp;
    if (tk >= n) break;
    const size_t row = (static_cast<size_t>(bh) * n + tk) * d;
    const float qx = on ? to_f32(q[row + lane]) : -INFINITY;
    const float mq = warp_max(qx);
    const float pq = on ? expf(qx - mq) : 0.f;
    const float s_q = pq / warp_sum(pq);
    const float gv = on ? to_f32(g[row + lane]) : 0.f;
    const float vv = on ? to_f32(v[row + lane]) : 0.f;
    const float s_k = on ? expf(to_f32(k[row + lane]) - mk[col]) / sk[col] : 0.f;
    float gc = 0.f, dkp = 0.f, dvv = 0.f;
    for (int j = 0; j < d; ++j) {
      gc += __shfl_sync(kFullMask, gv, j) * ct[j][col];    // (g C^T)_i, lane i
      dkp += __shfl_sync(kFullMask, vv, j) * dt[j][col];   // (v D^T)_i, lane i
      dvv += __shfl_sync(kFullMask, s_k, j) * dd[j][col];  // (s_k D)_e, lane e
    }
    gc *= scale;
    const float t = warp_sum(on ? gc * s_q : 0.f);
    if (on) {
      store(dq + row + lane, s_q * (gc - t));
      store(dk + row + lane, s_k * (dkp - rk[col]));
      store(dv + row + lane, dvv);
    }
  }
}

template <typename T>
int launch_backward(const void* q, const void* k, const void* v, const void* g, void* dq,
                    void* dk, void* dv, float* part_m, float* part_s, float* part_c,
                    float* part_d, float* state, int bh, int n, int d, cudaStream_t stream) {
  const int n_split = (n + kSplitTokens - 1) / kSplitTokens;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(d)));
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* gt = static_cast<const T*>(g);
  bwd_partial<T><<<dim3(bh, n_split), kPartialThreads, 0, stream>>>(
      qt, kt, vt, gt, part_m, part_s, part_c, part_d, n, d, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int combine_threads = (d * d + 31) / 32 * 32;
  bwd_combine<<<bh, combine_threads, 0, stream>>>(part_m, part_s, part_c, part_d, state,
                                                   n_split, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_tokens<T><<<dim3(bh, (n + kOutTokens - 1) / kOutTokens), kOutWarps * 32, 0, stream>>>(
      qt, kt, vt, gt, state, static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      n, d, scale);
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

// f32 per slice of the backward's combined state (sizes its scratch).
int lta_state_floats() { return kStateFloats; }

// q, k, v, g (the output's gradient), dq, dk, dv: (bh, n, d) contiguous, f32
// (is_bf16 == 0) or bf16. Scratch (f32): part_m, part_s (bh, n_split, d);
// part_c, part_d (bh, n_split, d, d); state (bh, lta_state_floats()).
// Launches on `stream`; returns cudaGetLastError().
int lta_backward(const void* q, const void* k, const void* v, const void* g, void* dq,
                 void* dk, void* dv, void* part_m, void* part_s, void* part_c, void* part_d,
                 void* state, int bh, int n, int d, int is_bf16, void* stream) {
  auto* pm = static_cast<float*>(part_m);
  auto* ps = static_cast<float*>(part_s);
  auto* pc = static_cast<float*>(part_c);
  auto* pd = static_cast<float*>(part_d);
  auto* st = static_cast<float*>(state);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_backward<__nv_bfloat16>(q, k, v, g, dq, dk, dv, pm, ps, pc, pd, st, bh, n,
                                          d, s);
  }
  return launch_backward<float>(q, k, v, g, dq, dk, dv, pm, ps, pc, pd, st, bh, n, d, s);
}

}  // extern "C"
