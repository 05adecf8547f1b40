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
// A (L, C, 6C) = [Wq | Wk | Wv | Wo | W1], w2 (L, 2C, C), both f32, and
// vecs (L, 16, 2C) f32 rows [bq, bk, bv, bo, b1, b2, ln1 scale, ln1 bias,
// ln2 scale, ln2 bias]. Products take operands in the token dtype and sum
// in f32; residuals, softmaxes and LayerNorms are f32; the token buffer is
// stored in the token dtype after every layer. In bf16 the operands are x,
// exp(k - m), v, Q', ctx / s, attn, x1 and GELU(h), as in the TPU kernel.
//
// Replaces the Pallas TPU kernel `_make_kernel` of
// lintransunet_tpu/ops/pallas_layer.py (pallas_call at :281, via
// `fused_transformer_stack`). The TPU kernel kept the whole token buffer
// in VMEM across layers; 28,704 x 128 tokens do not fit in a block's 227 KB
// of shared memory, so here each layer is three launches:
//
// * `stack_kv_*`, per token tile: the k/v projections, the tile's
//   per-feature max m and sum s of exp(k - m), and the per-head partial
//   ctx = exp(k - m)^T v. k and v never reach device memory.
// * `stack_ctx_combine`, per feature: merges the tiles' partials with
//   max-rescaling in a fixed order (no atomics, deterministic) into
//   ctx / s, as the linear-attention kernel's combine does.
// * `stack_apply_*`, per token tile: q projection, per-head softmax,
//   Q' ctx, o projection, residual, LN1, FFN with GELU, residual, LN2,
//   store. It updates the tile in place, so one buffer serves every layer.
//
// The bf16 kernels (`stack_kv_mma`, `stack_apply_mma`). A layer is
// ~16 C^2 FLOP per token against ~4 C bytes of token traffic: bound by
// operations. Every block streams the layer's weights (1 MB of bf16 at
// C = 256) from L2 once per token tile. The design:
// * `stack_pack_weights` lays the weights out once per call as bf16
//   panels of 16 K rows x 32 columns, XOR-swizzled for `ldmatrix`
//   (`packed_offset` is the layout rule). The chunk a product needs (KC
//   rows x NP output columns, `chunk_elems`) is then KC / 16 contiguous
//   spans, each one bulk copy (TMA) straight into the swizzled tile that
//   `ldsm_x4_t` reads, completing on the slot's mbarrier.
// * The chunks of all of a kernel's products form one stream through a
//   ring of kStages = 4 slots: while chunk g's MMAs run, chunks g + 1 ..
//   g + 3 are in flight, across products and their epilogues. One block
//   barrier per chunk.
// * Every product is `ldmatrix` + `mma.sync` m16n8k16 from swizzled tiles:
//   the projections and the FFN, e^T v (the token axis is the reduction:
//   e is read transposed) and Q' ctx (one 32 x 32 product per head, so no
//   head mask).
// * 32 tokens a block (kTile), one block per (tile, sequence): the 8 warps
//   split each product as 2 row groups x 4 column groups. At N 2160 and
//   4096 (C = 256, one block per SM) that is 68 and 128 blocks, so some of
//   the 132 SMs idle; 16-token tiles filling every SM were 12-14% slower
//   there (PERF.md, Findings), since a block's cost is per chunk step, not
//   per token.
// * LN1's f32 output stays in the registers of the warp that owns the row
//   until LN2 adds it back, which leaves shared memory for the ring.
//
// What bounds it now (tools/profile_stack.py on an H100; PERF.md, Findings):
// a block's step costs about the same whatever its chunk holds (16 or 32
// tokens, 8 to 16 MMAs a warp), ~1,300 cycles at C = 256, and the ring's
// depth (3, 4 or 6 stages) does not move it; with no weight copies at all
// a call is 17% faster, and without the per-chunk barrier too, 22%. So the
// L2 stream is not what binds but the per-step work of a thin tile:
// `ldmatrix` of each B element for only 32 tokens behind short dependent
// MMA chains; the epilogues take a quarter of a block. Hence 32 KB chunks
// at C = 256 (half the steps of 16 KB ones), and no clusters:
// multicasting each chunk into two or four blocks halves the L2 reads and
// was 2x slower.
//
// Shared memory of the bf16 kernels (kTile tokens, kStages chunks):
//   apply: s_a   kTile x 2C bf16, swizzled: the A operand of every product
//          s_g   kTile x (min(2C, 256) + 8) f32: a product's output
//          s_ctx C x 32 bf16: ctx / s as per-head B panels
//          ring  kStages chunks, then kStages mbarriers
//   kv:    s_a, s_g (C + 8 columns), ring.
// C = 256 (32 KB chunks): apply 209 KB, kv 193 KB, one block per SM.
// C = 128 (8 KB): apply 89 KB (two), kv 65 KB (three).
//
// The f32 kernels (`stack_kv_fma`, `stack_apply_fma`) are the first
// design, kept for f32 tokens: FMA products from shared memory, weights
// staged synchronously in 16-row chunks, 16 tokens per block.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ltu::swz;
using ltu::warp_max;
using ltu::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDk = 32;  // features per head: one per lane
constexpr float kLnEps = 1e-6f;
constexpr float kInvSqrt2 = 0.70710678118654752f;

constexpr int kTile = 32;       // tokens per bf16 block
constexpr int kF32Tokens = 16;  // tokens per f32 block

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// clock64 phase split of the layer kernel, built only with -DFST_PHASES
// (tools/profile_stack.py --phases): thread 0 of each block adds the cycles
// between marks to its phase; fst_phase_clocks reads and clears the sums.
// kWeights: waiting for a weight chunk, the chunk's barrier and its copy.
enum Phase { kLoad, kWeights, kMma, kSoftmaxCtx, kLn1, kGelu, kLn2, kPhases };
#ifdef FST_PHASES
__device__ unsigned long long g_phase[kPhases + 1];
struct PhaseClock {
  long long t;
  long long acc[kPhases];
  __device__ PhaseClock() {
    t = clock64();
    for (int i = 0; i < kPhases; ++i) acc[i] = 0;
  }
  __device__ void mark(int i) {
    const long long now = clock64();
    acc[i] += now - t;
    t = now;
  }
  __device__ void flush() {
    if (threadIdx.x != 0) return;
    for (int i = 0; i < kPhases; ++i) {
      atomicAdd(&g_phase[i], static_cast<unsigned long long>(acc[i]));
    }
    atomicAdd(&g_phase[kPhases], 1ull);
  }
};
#else
struct PhaseClock {
  __device__ void mark(int) {}
  __device__ void flush() {}
};
#endif

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

__device__ __forceinline__ float gelu(float h) { return 0.5f * h * (1.f + erff(h * kInvSqrt2)); }

// ---------------------------------------------------------------------------
// bf16: packed weights, the chunk stream and the block GEMM
// ---------------------------------------------------------------------------

// The packed layout of a K x N weight matrix (K a multiple of 16, N of 32):
// panels of 16 rows x 32 columns, 512 bf16 each, ordered [K / 16][N / 32];
// inside a panel, row r holds four 16-byte chunks, chunk c at swz(r, c, 4).
// So the columns [n0, n0 + np) of rows [k0, k0 + 16) are one contiguous
// span of np * 16 elements, and a chunk copied span by span is already the
// swizzled B tile that `ldsm_x4_t` reads. ctx / s (C x 32 per sequence) is
// laid out alike, one 32 x 32 matrix per head.
__host__ __device__ __forceinline__ int packed_panel(int kb, int pn, int n) {
  return (kb * (n / 32) + pn) * 512;
}

__device__ __forceinline__ int packed_offset(int k, int col, int n) {
  return packed_panel(k / 16, col / 32, n) + swz(k % 16, (col % 32) / 8, 4) + col % 8;
}

// packed[l] = the layer's A (C x 6C) then its w2 (2C x C), in bf16, packed.
// A thread rounds 8 consecutive columns of a row, one 16-byte chunk of the
// packed layout (row widths 6C and C are multiples of 8).
__global__ void __launch_bounds__(kThreads)
stack_pack_weights(const float* __restrict__ A, const float* __restrict__ w2,
                   bf16* __restrict__ packed, int c, int layers) {
  const size_t per_a = 6 * static_cast<size_t>(c) * c;
  const size_t per_layer = 8 * static_cast<size_t>(c) * c;
  const size_t chunks = per_layer / 8 * layers;
  for (size_t u = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x; u < chunks;
       u += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t l = u * 8 / per_layer, e = u * 8 - l * per_layer;
    const bool in_a = e < per_a;
    const size_t e2 = in_a ? e : e - per_a;
    const int n = in_a ? 6 * c : c;
    const float4* src = reinterpret_cast<const float4*>(
        in_a ? A + l * per_a + e2 : w2 + l * (per_layer - per_a) + e2);
    const float4 lo = src[0], hi = src[1];
    const uint4 v = make_uint4(ltu::pack_bf16x2(lo.x, lo.y), ltu::pack_bf16x2(lo.z, lo.w),
                               ltu::pack_bf16x2(hi.x, hi.y), ltu::pack_bf16x2(hi.z, hi.w));
    const int k = static_cast<int>(e2 / n), col = static_cast<int>(e2 % n);
    *reinterpret_cast<uint4*>(packed + l * per_layer + (in_a ? 0 : per_a) +
                              packed_offset(k, col, n)) = v;
  }
}

// One block per (feature i, batch): ctx / s over all tiles, merged with
// max-rescaling in a fixed order; into ctxn[b][i][:] (f32), or, if
// `panels` is given, in bf16 into panels[b] in the packed layout per head
// (the apply kernel's B operand).
__global__ void __launch_bounds__(kThreads)
stack_ctx_combine(const float* __restrict__ part_m, const float* __restrict__ part_s,
                  const float* __restrict__ part_ctx, float* __restrict__ ctxn,
                  bf16* __restrict__ panels, int tiles, int c) {
  __shared__ float red[kWarps];
  __shared__ float big_m, total_s;
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const size_t base = static_cast<size_t>(b) * tiles;

  float m = -INFINITY;
  for (int t = tid; t < tiles; t += kThreads) m = fmaxf(m, part_m[(base + t) * c + i]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (tid == 0) {
    float mm = red[0];
    for (int w = 1; w < kWarps; ++w) mm = fmaxf(mm, red[w]);
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
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float ss = 0.f;
    for (int w = 0; w < kWarps; ++w) ss += red[w];
    total_s = ss;
  }
  __syncthreads();

  // a warp reads four tiles' rows at once, lane = (tile, four columns); the
  // 32 per-(warp, tile) sums are added in a fixed order
  __shared__ float4 red4[kWarps * 4][kDk / 4];
  const int quarter = lane >> 3, col4 = lane & 7;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int t = warp * 4 + quarter; t < tiles; t += kWarps * 4) {  // unrolled: loads in flight
    const float w = expf(part_m[(base + t) * c + i] - M);
    const float4 v = reinterpret_cast<const float4*>(part_ctx + ((base + t) * c + i) * kDk)[col4];
    acc.x += v.x * w;
    acc.y += v.y * w;
    acc.z += v.z * w;
    acc.w += v.w * w;
  }
  red4[warp * 4 + quarter][col4] = acc;
  __syncthreads();
  if (warp == 0) {
    float total = 0.f;
    for (int w = 0; w < kWarps * 4; ++w) total += reinterpret_cast<const float*>(red4[w])[lane];
    if (panels != nullptr) {
      panels[static_cast<size_t>(b) * c * kDk + (i / kDk) * kDk * kDk +
             packed_offset(i % kDk, lane, kDk)] = __float2bfloat16(total / total_s);
    } else {
      ctxn[(static_cast<size_t>(b) * c + i) * kDk + lane] = total / total_s;
    }
  }
}

// bf16 elements of one weight chunk: 32 KB at C = 256, 8 KB below.
// Measured (PERF.md, Findings): 32 KB chunks take 7-14% off a block at
// C = 256 against 16 KB ones and add 10% at C = 128.
template <int C>
__host__ __device__ constexpr int chunk_elems() {
  return C >= 256 ? 16384 : 4096;
}

// Chunks in a block's ring: three in flight while one is read (three
// stages measured alike, six slower).
constexpr int kStages = 4;

// One product's weights: columns [col0, col0 + np) of a packed K x n
// matrix, streamed in chunks of kc rows (chunks = K / kc).
struct Pass {
  const bf16* w;
  int n, col0, np, kc, chunks;
};

// The ring of S weight chunks of one block. Chunk g of the kernel's stream
// (the passes' chunks in order) lands in slot g % S: thread 0 arms slot
// g's mbarrier with the chunk's bytes and starts one bulk copy (TMA) per
// 16-row span; every thread waits on the barrier's parity (g / S) & 1.
template <int CHUNK, int NPASS, int S>
struct Ring {
  static_assert(S >= 3, "a ring of at least three chunks");
  bf16* slots;
  unsigned long long* full;  // S mbarriers
  Pass pass[NPASS];

  __device__ __forceinline__ void issue(int g) const {
    bf16* dst = slots + (g % S) * CHUNK;
    unsigned long long* bar = full + g % S;
#pragma unroll
    for (int p = 0; p < NPASS; ++p) {
      if (g >= 0 && g < pass[p].chunks) {  // g: the chunk's index in pass p
        const Pass& ps = pass[p];
        const int kb0 = g * ps.kc / 16;
        const unsigned span_bytes = ps.np * 32;  // 16 rows of np bf16
        ltu::mbar_expect_tx(bar, span_bytes * (ps.kc / 16));
        for (int s = 0; s < ps.kc / 16; ++s) {
          ltu::bulk_copy(dst + s * ps.np * 16, ps.w + packed_panel(kb0 + s, ps.col0 / 32, ps.n),
                         span_bytes, bar);
        }
      }
      g -= pass[p].chunks;
    }
  }

  // Before anything else in the kernel (thread 0): the barriers and the
  // first S - 1 chunks. The caller's barrier (chunk 0's) publishes the
  // barriers' initialisation before anyone waits on them.
  __device__ __forceinline__ void prologue() const {
    if (threadIdx.x != 0) return;
    for (int s = 0; s < S; ++s) ltu::mbar_init(full + s, 1);
    ltu::fence_mbar_init();
    for (int s = 0; s < S - 1; ++s) issue(s);
  }

  // The start of chunk g: wait for it, then (after the block barrier, which
  // also frees the slot that chunk g - 1 used) start chunk g + S - 1 into
  // that slot. At chunk 0 the tile's own cp.async copies land first.
  // Returns chunk g's slot.
  __device__ __forceinline__ const bf16* next(int g, PhaseClock& ph) const {
    if (g == 0) {
      ltu::cp_async_wait_all();
      __syncthreads();  // the barriers are initialised
    }
    ltu::mbar_wait(full + g % S, (g / S) & 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      ltu::fence_proxy_async();  // the block's reads of the slot come first
      issue(g + S - 1);
    }
    ph.mark(kWeights);
    return slots + (g % S) * CHUNK;
  }
};

// s_g[:, 0:NP] = s_a[:, a_col0 : a_col0 + K] (kTile rows) times the pass's
// weights, streamed through the ring as chunks g, g + 1, ... (g advances).
// s_a: kTile x 2C bf16 with ACPR = 2C / 8 swizzled chunks per row.
template <int NP, int KC, int K, int ACPR, typename R>
__device__ __forceinline__ void gemm_pass(const R& ring, int& g, const bf16* s_a, int a_col0,
                                          float* s_g, int ld_g, PhaseClock& ph) {
  constexpr int MG = kTile / 16;
  constexpr int NG = kWarps / MG;
  constexpr int WN = NP / NG >= 16 ? NP / NG : 16;
  constexpr int NT = WN / 8;
  static_assert(NP % 32 == 0 && KC % 16 == 0 && K % KC == 0, "pass shape");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % MG, n_base = (warp / MG) * WN;
  const bool active = n_base < NP;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int k0 = 0; k0 < K; k0 += KC) {
    const bf16* slot = ring.next(g++, ph);
    if (active) {
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        unsigned a[4];
        ltu::ldsm_x4(a, s_a + swz(rg * 16 + (lane & 15),
                                  (a_col0 + k0 + ks * 16) / 8 + (lane >> 4), ACPR));
#pragma unroll
        for (int pp = 0; pp < WN / 16; ++pp) {
          const int P = n_base / 16 + pp;  // 16-column pair within the pass
          unsigned b[4];
          ltu::ldsm_x4_t(b, slot + (ks * (NP / 32) + P / 2) * 512 +
                                swz(lane & 15, (P & 1) * 2 + (lane >> 4), 4));
          ltu::mma_bf16_16816(acc[2 * pp], a, b[0], b[1]);
          ltu::mma_bf16_16816(acc[2 * pp + 1], a, b[2], b[3]);
        }
      }
    }
    ph.mark(kMma);
  }
  if (active) {
    const int row = rg * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = n_base + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(s_g + row * ld_g + col) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(s_g + (row + 8) * ld_g + col) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// Starts the copies of the block's token tile into s_a's columns [0, C)
// (cp.async, in the group that the ring's first chunk commits); rows past
// `count` are zeros.
template <int C>
__device__ __forceinline__ void load_tile_async(const bf16* __restrict__ x, bf16* s_a, int t0,
                                                int count) {
  constexpr int U = C / 8;
  for (int u = threadIdx.x; u < kTile * U; u += kThreads) {
    const int r = u / U, cu = u - r * U;
    bf16* dst = s_a + swz(r, cu, 2 * C / 8);
    if (r < count) {
      ltu::cp_async16(dst, x + static_cast<size_t>(t0 + r) * C + cu * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ void put(bf16* s_a, int acpr, int r, int col, float v) {
  s_a[swz(r, col / 8, acpr) + col % 8] = __float2bfloat16(v);
}

__device__ __forceinline__ float get(const bf16* s_a, int acpr, int r, int col) {
  return __bfloat162float(s_a[swz(r, col / 8, acpr) + col % 8]);
}

// Shared-memory plan of the bf16 kernels, in bytes (see the header note).
template <int C, bool APPLY>
struct MmaPlan {
  static constexpr int kLdG = (APPLY ? cmin(2 * C, 256) : C) + 8;
  static constexpr size_t a = 0;
  static constexpr size_t g = ltu::align_up(a + 2 * kTile * 2 * C, 128);
  static constexpr size_t ctx = ltu::align_up(g + 4 * kTile * kLdG, 128);
  static constexpr size_t ring = ltu::align_up(ctx + (APPLY ? 2 * C * kDk : 0), 128);
  static constexpr size_t bars = ltu::align_up(ring + 2 * kStages * chunk_elems<C>(), 8);
  static constexpr size_t total = bars + 8 * kStages;
};

// One block per (token tile, batch): the k and v projections, the tile's
// K-softmax partials and its partial ctx.
template <int C>
__global__ void __launch_bounds__(kThreads, C >= 256 ? 1 : 2)
stack_kv_mma(const bf16* __restrict__ x, const bf16* __restrict__ packed,
             const float* __restrict__ vec, float* __restrict__ part_m,
             float* __restrict__ part_s, float* __restrict__ part_ctx, int n) {
  using Plan = MmaPlan<C, false>;
  constexpr int ACPR = 2 * C / 8;
  constexpr int CH = chunk_elems<C>();
  constexpr int KC = cmin(C, CH / C);
  constexpr int LDG = Plan::kLdG;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem + Plan::a);
  float* s_g = reinterpret_cast<float*>(smem + Plan::g);
  const int tile = blockIdx.x, tiles = gridDim.x, b = blockIdx.y;
  const int t0 = tile * kTile;
  const int count = min(kTile, n - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  PhaseClock ph;  // not flushed: the split covers the apply kernel

  const Ring<CH, 2, kStages> ring{reinterpret_cast<bf16*>(smem + Plan::ring),
                                  reinterpret_cast<unsigned long long*>(smem + Plan::bars),
                                  {{packed, 6 * C, C, C, KC, C / KC},
                                   {packed, 6 * C, 2 * C, C, KC, C / KC}}};
  load_tile_async<C>(x + static_cast<size_t>(b) * n * C, s_a, t0, count);
  ring.prologue();

  int g = 0;
  gemm_pass<C, KC, C, ACPR>(ring, g, s_a, 0, s_g, LDG, ph);  // k
  __syncthreads();
  // per feature: the tile's max and sum of exp; e = exp(k - m), rounded to
  // bf16 as the ctx product's operand, into s_a's columns [C, 2C)
  const size_t part = static_cast<size_t>(b) * tiles + tile;
  for (int f = tid; f < C; f += kThreads) {
    const float bk = vec[1 * 2 * C + f];
    float m = -INFINITY;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      if (r < count) m = fmaxf(m, s_g[r * LDG + f] + bk);
    }
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const float e = r < count ? expf(s_g[r * LDG + f] + bk - m) : 0.f;
      s += e;
      put(s_a, ACPR, r, C + f, e);
    }
    part_m[part * C + f] = m;
    part_s[part * C + f] = s;
  }
  gemm_pass<C, KC, C, ACPR>(ring, g, s_a, 0, s_g, LDG, ph);  // v
  __syncthreads();
  // v + bv in bf16 over x (columns [0, C)), zero past count
  for (int idx = tid; idx < kTile * C / 2; idx += kThreads) {
    const int r = idx / (C / 2), f = (idx - r * (C / 2)) * 2;
    const float2 v = *reinterpret_cast<const float2*>(s_g + r * LDG + f);
    const bool in = r < count;
    *reinterpret_cast<unsigned*>(s_a + swz(r, f / 8, ACPR) + f % 8) =
        ltu::pack_bf16x2(in ? v.x + vec[2 * 2 * C + f] : 0.f,
                         in ? v.y + vec[2 * 2 * C + f + 1] : 0.f);
  }
  __syncthreads();
  // ctx[i][j] = sum_r e[r][i] v[r][j] per head: M = the head's 32 features
  // (two 16-row tiles), N = 32, K = the tile's tokens, e read transposed
  for (int u = warp; u < C / 32 * 2; u += kWarps) {
    const int hl = u / 2, mt = u % 2;
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      unsigned a[4];
      ltu::ldsm_x4_t(a, s_a + swz(ks * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  (C + hl * 32 + mt * 16) / 8 + ((lane >> 3) & 1), ACPR));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned bb[4];
        ltu::ldsm_x4_t(bb, s_a + swz(ks * 16 + (lane & 15), hl * 4 + p * 2 + (lane >> 4), ACPR));
        ltu::mma_bf16_16816(acc[2 * p], a, bb[0], bb[1]);
        ltu::mma_bf16_16816(acc[2 * p + 1], a, bb[2], bb[3]);
      }
    }
    const int i = hl * 32 + mt * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      *reinterpret_cast<float2*>(part_ctx + (part * C + i) * kDk + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(part_ctx + (part * C + i + 8) * kDk + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// One block per (token tile, batch): the rest of the layer, in place.
// s_a's columns over the layer: x in [0, C); Q', then attn in place, in
// [C, 2C); x1 in [C, 2C) (x is dead by then); h over [0, 2C).
template <int C>
__global__ void __launch_bounds__(kThreads, C >= 256 ? 1 : 2)
stack_apply_mma(const bf16* x_in, bf16* x_out, const bf16* __restrict__ packed,
                const float* __restrict__ vec, const bf16* __restrict__ ctx_panels, int n,
                float inv_sqrt_dk) {
  using Plan = MmaPlan<C, true>;
  constexpr int C2 = 2 * C;
  constexpr int H = C / kDk;
  constexpr int ACPR = C2 / 8;
  constexpr int CH = chunk_elems<C>();
  constexpr int NPW1 = cmin(C2, 256);  // W1's output columns per pass
  constexpr int W1P = C2 / NPW1;       // 1, or 2 at C = 256
  constexpr int KC_C = cmin(C, CH / C);
  constexpr int KC_W1 = cmin(C, CH / NPW1);
  constexpr int KC_W2 = cmin(C2, CH / C);
  constexpr int LDG = Plan::kLdG;
  constexpr int PER_LANE = C / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* s_a = reinterpret_cast<bf16*>(smem + Plan::a);
  float* s_g = reinterpret_cast<float*>(smem + Plan::g);
  bf16* s_ctx = reinterpret_cast<bf16*>(smem + Plan::ctx);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int count = min(kTile, n - t0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  PhaseClock ph;

  // the stream: q, o, W1 (one or two passes), W2
  const bf16* w2p = packed + 6 * C * C;
  using R = Ring<CH, 3 + W1P, kStages>;
  const R ring = [&] {
    R r{reinterpret_cast<bf16*>(smem + Plan::ring),
        reinterpret_cast<unsigned long long*>(smem + Plan::bars), {}};
    r.pass[0] = {packed, 6 * C, 0, C, KC_C, C / KC_C};
    r.pass[1] = {packed, 6 * C, 3 * C, C, KC_C, C / KC_C};
#pragma unroll
    for (int p = 0; p < W1P; ++p) {
      r.pass[2 + p] = {packed, 6 * C, 4 * C + p * NPW1, NPW1, KC_W1, C / KC_W1};
    }
    r.pass[2 + W1P] = {w2p, C, 0, C, KC_W2, C2 / KC_W2};
    return r;
  }();
  // the tile and ctx / s (already in the B layout) join the first chunk's
  // copy group
  load_tile_async<C>(x_in + static_cast<size_t>(b) * n * C, s_a, t0, count);
  for (int u = tid; u < C * kDk / 8; u += kThreads) {
    ltu::cp_async16(s_ctx + u * 8, ctx_panels + static_cast<size_t>(b) * C * kDk + u * 8);
  }
  ring.prologue();
  ph.mark(kLoad);

  int g = 0;
  gemm_pass<C, KC_C, C, ACPR>(ring, g, s_a, 0, s_g, LDG, ph);  // q = x Wq
  __syncthreads();
  // Q' = per-head feature softmax / sqrt(d_k), in bf16 into [C, 2C): a warp
  // per token, its heads unrolled so their reductions overlap
  for (int r = warp; r < kTile; r += kWarps) {
    float qv[H], mx[H], sum[H];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      qv[h] = s_g[r * LDG + h * kDk + lane] + vec[h * kDk + lane];
      mx[h] = qv[h];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int h = 0; h < H; ++h) mx[h] = fmaxf(mx[h], __shfl_xor_sync(ltu::kFullMask, mx[h], o));
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      qv[h] = expf(qv[h] - mx[h]);
      sum[h] = qv[h];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int h = 0; h < H; ++h) sum[h] += __shfl_xor_sync(ltu::kFullMask, sum[h], o);
    }
#pragma unroll
    for (int h = 0; h < H; ++h) put(s_a, ACPR, r, C + h * kDk + lane, qv[h] / sum[h] * inv_sqrt_dk);
  }
  __syncthreads();
  // attn = Q' ctx, one 32 x 32 product per (16-row group, head), written
  // in place: each warp reads and writes only its own rows and head
  for (int u = warp; u < kTile / 16 * H; u += kWarps) {
    const int rg = u % (kTile / 16), h = u / (kTile / 16);
    float acc[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned a[4];
      ltu::ldsm_x4(a, s_a + swz(rg * 16 + (lane & 15), (C + h * kDk) / 8 + ks * 2 + (lane >> 4),
                                ACPR));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned bb[4];
        ltu::ldsm_x4_t(bb, s_ctx + h * 1024 + ks * 512 + swz(lane & 15, p * 2 + (lane >> 4), 4));
        ltu::mma_bf16_16816(acc[2 * p], a, bb[0], bb[1]);
        ltu::mma_bf16_16816(acc[2 * p + 1], a, bb[2], bb[3]);
      }
    }
    const int row = rg * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = C + h * kDk + 8 * j + 2 * (lane & 3);
      *reinterpret_cast<unsigned*>(s_a + swz(row, col / 8, ACPR) + col % 8) =
          ltu::pack_bf16x2(acc[j][0], acc[j][1]);
      *reinterpret_cast<unsigned*>(s_a + swz(row + 8, col / 8, ACPR) + col % 8) =
          ltu::pack_bf16x2(acc[j][2], acc[j][3]);
    }
  }
  ph.mark(kSoftmaxCtx);

  // x1 = LN1(x + attn Wo + bo): f32 in the registers of the warp that
  // owns row r (warp + 8 k) until LN2, bf16 into s_a[:, C:2C]
  gemm_pass<C, KC_C, C, ACPR>(ring, g, s_a, C, s_g, LDG, ph);
  __syncthreads();
  float x1[kTile / kWarps][PER_LANE];
#pragma unroll
  for (int k = 0; k < kTile / kWarps; ++k) {
    const int r = warp + kWarps * k;
    float* v = x1[k];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int f = lane + 32 * j;
      v[j] = get(s_a, ACPR, r, f) + s_g[r * LDG + f] + vec[3 * C2 + f];
    }
    layer_norm_row(v, PER_LANE, C, vec + 6 * C2, vec + 7 * C2);
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) put(s_a, ACPR, r, C + lane + 32 * j, v[j]);
  }
  ph.mark(kLn1);

  // h = GELU(x1 W1 + b1) in bf16 into s_a[:, 0:2C]. With two passes the
  // first writes [0, C), which the second's MMAs (reading [C, 2C)) leave
  // alone; the second writes [C, 2C) after its MMAs.
#pragma unroll
  for (int p = 0; p < W1P; ++p) {
    gemm_pass<NPW1, KC_W1, C, ACPR>(ring, g, s_a, C, s_g, LDG, ph);
    __syncthreads();
#pragma unroll 4
    for (int idx = tid; idx < kTile * NPW1 / 2; idx += kThreads) {
      const int r = idx / (NPW1 / 2), f = (idx - r * (NPW1 / 2)) * 2, col = p * NPW1 + f;
      const float2 hv = *reinterpret_cast<const float2*>(s_g + r * LDG + f);
      *reinterpret_cast<unsigned*>(s_a + swz(r, col / 8, ACPR) + col % 8) = ltu::pack_bf16x2(
          gelu(hv.x + vec[4 * C2 + col]), gelu(hv.y + vec[4 * C2 + col + 1]));
    }
    ph.mark(kGelu);
  }

  // x = LN2(x1 + h W2 + b2), stored in bf16
  gemm_pass<C, KC_W2, C2, ACPR>(ring, g, s_a, 0, s_g, LDG, ph);
  __syncthreads();
  bf16* out = x_out + static_cast<size_t>(b) * n * C;
#pragma unroll
  for (int k = 0; k < kTile / kWarps; ++k) {
    const int r = warp + kWarps * k;
    float v[PER_LANE];
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int f = lane + 32 * j;
      v[j] = x1[k][j] + s_g[r * LDG + f] + vec[5 * C2 + f];
    }
    layer_norm_row(v, PER_LANE, C, vec + 8 * C2, vec + 9 * C2);
    if (r < count) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        out[static_cast<size_t>(t0 + r) * C + lane + 32 * j] = __float2bfloat16(v[j]);
      }
    }
  }
  ph.mark(kLn2);
  ph.flush();
}

// ---------------------------------------------------------------------------
// f32: the FMA kernels
// ---------------------------------------------------------------------------

constexpr int kNP = 256;     // output columns per GEMM pass
constexpr int kPadT = 8;     // row padding of the operand tile
constexpr int kPadF = 4;     // row padding of GEMM outputs
constexpr int kLdW = kNP + kPadT;
constexpr int kF32Chunk = 16;  // K rows of a staged weight chunk

// Shared-memory plan of one f32 block, in bytes, for width c.
struct FmaPlan {
  static constexpr int TN = kF32Tokens;
  size_t a, g, x1, w, ctx, total;
  int ld_a, ld_g;
  __host__ __device__ FmaPlan(int c, bool apply) {
    ld_a = 2 * c + kPadT;
    ld_g = 2 * c + kPadF;
    a = 0;
    g = ltu::align_up(a + sizeof(float) * TN * ld_a, 128);
    w = ltu::align_up(g + sizeof(float) * TN * ld_g, 128);
    x1 = ltu::align_up(w + sizeof(float) * kF32Chunk * kLdW, 128);
    ctx = ltu::align_up(x1 + (apply ? sizeof(float) * TN * c : 0), 128);
    total = ctx + (apply ? sizeof(float) * c * kDk : 0);
  }
};

// s_w[r][j] = w[k0 + r][n0 + j] for r < kF32Chunk, j < np, in 16-byte
// copies; between barriers, so s_w's previous readers are done and its new
// values are seen by all.
__device__ void stage_weights(const float* __restrict__ w, int ldw, int k0, int n0, int np,
                              float* s_w) {
  const int units = np / 4;
  __syncthreads();
  for (int u = threadIdx.x; u < kF32Chunk * units; u += kThreads) {
    const int r = u / units, cu = u - r * units;
    *reinterpret_cast<float4*>(s_w + r * kLdW + cu * 4) = *reinterpret_cast<const float4*>(
        w + static_cast<size_t>(k0 + r) * ldw + n0 + cu * 4);
  }
  __syncthreads();
}

// s_out[r][n0 + j] = sum_k s_in[r][k] w[k][j] for the block's rows, k < K,
// j < nout. w: device memory with row stride ldw, offset to its first
// column; staged through s_w in chunks of kF32Chunk rows. Ends with a
// barrier, so s_out is ready and s_in may be overwritten.
__device__ void block_gemm_fma(const float* s_in, int ld_in, int K, const float* __restrict__ w,
                               int ldw, int nout, float* s_w, float* s_out, int ld_out) {
  constexpr int TN = kF32Tokens;
  const int tid = threadIdx.x;
  for (int n0 = 0; n0 < nout; n0 += kNP) {
    const int np = min(kNP, nout - n0);
    // thread -> column n0 + col, rows [rg * rpt, rg * rpt + rpt)
    const int groups = kThreads / np;
    const int col = tid % np;
    const int rg = tid / np;
    const int rpt = TN / groups;
    float acc[TN];
#pragma unroll
    for (int r = 0; r < TN; ++r) acc[r] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kF32Chunk) {
      stage_weights(w, ldw, k0, n0, np, s_w);
      for (int kk = 0; kk < kF32Chunk; ++kk) {
        const float wv = s_w[kk * kLdW + col];
#pragma unroll
        for (int r = 0; r < TN; ++r) {
          if (r < rpt) acc[r] += s_in[(rg * rpt + r) * ld_in + k0 + kk] * wv;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TN; ++r) {
      if (r < rpt) s_out[(rg * rpt + r) * ld_out + n0 + col] = acc[r];
    }
  }
  __syncthreads();
}

// The block's token tile (zeros past n) into s_a; also into x32 if given.
__device__ void load_tile_fma(const float* __restrict__ x, float* s_a, int ld_a, float* x32,
                              int t0, int count, int c) {
  for (int idx = threadIdx.x; idx < kF32Tokens * c; idx += kThreads) {
    const int r = idx / c, f = idx - r * c;
    const float v = r < count ? x[static_cast<size_t>(t0 + r) * c + f] : 0.f;
    s_a[r * ld_a + f] = v;
    if (x32 != nullptr) x32[r * c + f] = v;
  }
}

// One block per (token tile, batch): the tile's K-softmax partials and ctx.
__global__ void __launch_bounds__(kThreads)
stack_kv_fma(const float* __restrict__ x, const float* __restrict__ A,
             const float* __restrict__ vec, float* __restrict__ part_m,
             float* __restrict__ part_s, float* __restrict__ part_ctx, int n, int c) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TN = kF32Tokens;
  const FmaPlan plan(c, false);
  float* s_a = reinterpret_cast<float*>(smem + plan.a);
  float* s_g = reinterpret_cast<float*>(smem + plan.g);
  float* s_w = reinterpret_cast<float*>(smem + plan.w);
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;
  const int t0 = tile * TN;
  const int count = min(TN, n - t0);
  const int ld_g = plan.ld_g;

  load_tile_fma(x + static_cast<size_t>(b) * n * c, s_a, plan.ld_a, nullptr, t0, count, c);
  __syncthreads();
  // s_g[:, 0:c] = x Wk, s_g[:, c:2c] = x Wv
  block_gemm_fma(s_a, plan.ld_a, c, A + c, 6 * c, 2 * c, s_w, s_g, ld_g);

  const size_t part = static_cast<size_t>(b) * tiles + tile;
  // per feature: the tile's max and sum of exp; exp(k - m) replaces k
  for (int f = threadIdx.x; f < c; f += kThreads) {
    const float bk = vec[1 * 2 * c + f];
    float m = -INFINITY;
    for (int r = 0; r < count; ++r) m = fmaxf(m, s_g[r * ld_g + f] + bk);
    float s = 0.f;
    for (int r = 0; r < TN; ++r) {
      const float e = r < count ? expf(s_g[r * ld_g + f] + bk - m) : 0.f;
      s += e;
      s_g[r * ld_g + f] = e;
    }
    part_m[part * c + f] = m;
    part_s[part * c + f] = s;
  }
  for (int idx = threadIdx.x; idx < TN * c; idx += kThreads) {
    const int r = idx / c, f = idx - r * c;
    float* p = s_g + r * ld_g + c + f;
    *p = r < count ? *p + vec[2 * 2 * c + f] : 0.f;
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

// One block per (token tile, batch): the rest of the layer, in place.
__global__ void __launch_bounds__(kThreads)
stack_apply_fma(const float* x_in, float* x_out, const float* __restrict__ A,
                const float* __restrict__ w2, const float* __restrict__ vec,
                const float* __restrict__ ctxn, int n, int c, int heads, float inv_sqrt_dk) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TN = kF32Tokens;
  constexpr int kMaxPerLane = 256 / 32;
  const FmaPlan plan(c, true);
  float* s_a = reinterpret_cast<float*>(smem + plan.a);
  float* s_g = reinterpret_cast<float*>(smem + plan.g);
  float* s_w = reinterpret_cast<float*>(smem + plan.w);
  float* s_x1 = reinterpret_cast<float*>(smem + plan.x1);
  float* s_ctx = reinterpret_cast<float*>(smem + plan.ctx);
  const int ld_a = plan.ld_a, ld_g = plan.ld_g;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TN;
  const int count = min(TN, n - t0);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int per_lane = c / 32;
  const int c2 = 2 * c;

  load_tile_fma(x_in + static_cast<size_t>(b) * n * c, s_a, ld_a, s_x1, t0, count, c);
  for (int idx = tid; idx < c * kDk; idx += kThreads) {
    s_ctx[idx] = ctxn[static_cast<size_t>(b) * c * kDk + idx];
  }
  __syncthreads();

  // q = x Wq; per (token, head): feature softmax / sqrt(d_k), then Q' ctx
  block_gemm_fma(s_a, ld_a, c, A, 6 * c, c, s_w, s_g, ld_g);
  for (int p = warp; p < TN * heads; p += kWarps) {
    const int r = p / heads, h = p % heads;
    const int f = h * kDk + lane;
    const float qv = s_g[r * ld_g + f] + vec[f];
    const float e = expf(qv - warp_max(qv));
    const float qs = e / warp_sum(e) * inv_sqrt_dk;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < kDk; ++i) {
      acc += __shfl_sync(ltu::kFullMask, qs, i) * s_ctx[(h * kDk + i) * kDk + lane];
    }
    s_a[r * ld_a + f] = acc;
  }
  __syncthreads();

  // x1 = LN1(x + attn Wo + bo)
  block_gemm_fma(s_a, ld_a, c, A + 3 * c, 6 * c, c, s_w, s_g, ld_g);
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
      s_a[r * ld_a + f] = v[j];
    }
  }
  __syncthreads();

  // h = GELU(x1 W1 + b1)
  block_gemm_fma(s_a, ld_a, c, A + 4 * c, 6 * c, c2, s_w, s_g, ld_g);
  for (int idx = tid; idx < TN * c2; idx += kThreads) {
    const int r = idx / c2, f = idx - r * c2;
    s_a[r * ld_a + f] = gelu(s_g[r * ld_g + f] + vec[4 * c2 + f]);
  }
  __syncthreads();

  // x = LN2(x1 + h W2 + b2)
  block_gemm_fma(s_a, ld_a, c2, w2, c, c, s_w, s_g, ld_g);
  float* out = x_out + static_cast<size_t>(b) * n * c;
  for (int r = warp; r < TN; r += kWarps) {
    float v[kMaxPerLane];
    for (int j = 0; j < per_lane; ++j) {
      const int f = lane + 32 * j;
      v[j] = s_x1[r * c + f] + s_g[r * ld_g + f] + vec[5 * c2 + f];
    }
    layer_norm_row(v, per_lane, c, vec + 8 * c2, vec + 9 * c2);
    if (r < count) {
      for (int j = 0; j < per_lane; ++j) out[static_cast<size_t>(t0 + r) * c + lane + 32 * j] = v[j];
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

int num_tiles(int n, int is_bf16) {
  const int tn = is_bf16 ? kTile : kF32Tokens;
  return (n + tn - 1) / tn;
}

float inv_sqrt_dk() { return static_cast<float>(1.0 / sqrt(static_cast<double>(kDk))); }

template <int C>
int launch_mma(const void* x, void* out, const float* A, const float* w2, const float* vecs,
               bf16* packed, float* part_m, float* part_s, float* part_ctx, bf16* panels,
               int batch, int n, int layers, cudaStream_t stream) {
  using KvPlan = MmaPlan<C, false>;
  using ApplyPlan = MmaPlan<C, true>;
  static int ready = -1;  // the device whose kernel attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ready != dev) {
    err = cudaFuncSetAttribute(stack_kv_mma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(KvPlan::total));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(stack_apply_mma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(ApplyPlan::total));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = dev;
  }
  const size_t units = (static_cast<size_t>(C) * C * layers + kThreads - 1) / kThreads;
  stack_pack_weights<<<static_cast<int>(units < 1024 ? units : 1024), kThreads, 0, stream>>>(
      A, w2, packed, C, layers);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xb = static_cast<const bf16*>(x);
  auto* ob = static_cast<bf16*>(out);
  const size_t per_layer = 8 * static_cast<size_t>(C) * C;
  const int tiles = num_tiles(n, 1);
  const dim3 grid(tiles, batch);
  for (int l = 0; l < layers; ++l) {
    const bf16* p_l = packed + l * per_layer;
    const float* vec_l = vecs + static_cast<size_t>(l) * 16 * 2 * C;
    const bf16* in = l == 0 ? xb : ob;
    stack_kv_mma<C><<<grid, kThreads, KvPlan::total, stream>>>(in, p_l, vec_l, part_m, part_s,
                                                              part_ctx, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stack_ctx_combine<<<dim3(C, batch), kThreads, 0, stream>>>(part_m, part_s, part_ctx, nullptr,
                                                               panels, tiles, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stack_apply_mma<C><<<grid, kThreads, ApplyPlan::total, stream>>>(in, ob, p_l, vec_l, panels,
                                                                     n, inv_sqrt_dk());
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int launch_fma(const float* x, float* out, const float* A, const float* w2, const float* vecs,
               float* part_m, float* part_s, float* part_ctx, float* ctxn, int batch, int n,
               int c, int heads, int layers, cudaStream_t stream) {
  const size_t kv_smem = FmaPlan(c, false).total;
  const size_t apply_smem = FmaPlan(c, true).total;
  cudaError_t err = cudaFuncSetAttribute(stack_kv_fma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kv_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(stack_apply_fma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(apply_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = num_tiles(n, 0);
  const dim3 grid(tiles, batch);
  for (int l = 0; l < layers; ++l) {
    const float* a_l = A + static_cast<size_t>(l) * c * 6 * c;
    const float* w2_l = w2 + static_cast<size_t>(l) * 2 * c * c;
    const float* vec_l = vecs + static_cast<size_t>(l) * 16 * 2 * c;
    const float* in = l == 0 ? x : out;
    stack_kv_fma<<<grid, kThreads, kv_smem, stream>>>(in, a_l, vec_l, part_m, part_s, part_ctx, n,
                                                      c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stack_ctx_combine<<<dim3(c, batch), kThreads, 0, stream>>>(part_m, part_s, part_ctx, ctxn,
                                                               nullptr, tiles, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stack_apply_fma<<<grid, kThreads, apply_smem, stream>>>(in, out, a_l, w2_l, vec_l, ctxn, n, c,
                                                            heads, inv_sqrt_dk());
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// Blocks per SM that the occupancy calculator allows the bf16 kv (apply
// == 0) or apply kernel at width C, with its dynamic shared memory in
// *smem_bytes; negative: a CUDA error.
template <int C>
int occupancy_mma(int apply, int* smem_bytes) {
  const void* fn = apply ? reinterpret_cast<const void*>(stack_apply_mma<C>)
                         : reinterpret_cast<const void*>(stack_kv_mma<C>);
  const size_t smem = apply ? MmaPlan<C, true>::total : MmaPlan<C, false>::total;
  *smem_bytes = static_cast<int>(smem);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem_bytes);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" {

// Blocks per SM of the bf16 kv (apply == 0) or apply kernel at width c, and
// its dynamic shared memory in bytes (*smem_bytes); negative: a CUDA error.
int fst_occupancy(int c, int apply, void* smem_bytes) {
  auto* smem = static_cast<int*>(smem_bytes);
  switch (c) {
    case 32: return occupancy_mma<32>(apply, smem);
    case 64: return occupancy_mma<64>(apply, smem);
    case 128: return occupancy_mma<128>(apply, smem);
    case 256: return occupancy_mma<256>(apply, smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Token tiles per sequence: sizes the wrapper's partial-sum scratch.
int fst_num_tiles(int n, int is_bf16) { return num_tiles(n, is_bf16); }

// x, out: (batch, n, c) contiguous, f32 (is_bf16 == 0) or bf16; out may not
// alias x. A (layers, c, 6c), w2 (layers, 2c, c) and vecs (layers, 16, 2c):
// f32. c in {32, 64, 128, 256}, c = 32 * heads. packed: bf16 scratch of
// layers * 8 c^2 elements (bf16 only; the kernel packs the weights into
// it). Scratch (f32): part_m, part_s (batch, tiles, c); part_ctx (batch,
// tiles, c, 32); ctxn (batch, c, 32). Launches on `stream`; returns the
// first CUDA error (0 on success).
int fst_forward(const void* x, void* out, const void* A, const void* w2, const void* vecs,
                void* packed, void* part_m, void* part_s, void* part_ctx, void* ctxn, int batch,
                int n, int c, int heads, int layers, int is_bf16, void* stream) {
  const auto* a = static_cast<const float*>(A);
  const auto* w = static_cast<const float*>(w2);
  const auto* v = static_cast<const float*>(vecs);
  auto* pk = static_cast<bf16*>(packed);
  auto* pm = static_cast<float*>(part_m);
  auto* ps = static_cast<float*>(part_s);
  auto* pc = static_cast<float*>(part_ctx);
  auto* cn = static_cast<float*>(ctxn);
  auto* panels = static_cast<bf16*>(ctxn);  // bf16: ctx / s as per-head B panels
  auto s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    return launch_fma(static_cast<const float*>(x), static_cast<float*>(out), a, w, v, pm, ps, pc,
                      cn, batch, n, c, heads, layers, s);
  }
  if (c != 32 * heads || pk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 32: return launch_mma<32>(x, out, a, w, v, pk, pm, ps, pc, panels, batch, n, layers, s);
    case 64: return launch_mma<64>(x, out, a, w, v, pk, pm, ps, pc, panels, batch, n, layers, s);
    case 128: return launch_mma<128>(x, out, a, w, v, pk, pm, ps, pc, panels, batch, n, layers, s);
    case 256: return launch_mma<256>(x, out, a, w, v, pk, pm, ps, pc, panels, batch, n, layers, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#ifdef FST_PHASES
// Copies the phase sums (kPhases cycle counts, then the block count) to
// host memory `out` (kPhases + 1 uint64) and clears them.
int fst_phase_clocks(void* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  const unsigned long long zero[kPhases + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif

}  // extern "C"
