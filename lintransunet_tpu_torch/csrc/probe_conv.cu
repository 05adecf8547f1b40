// Channels-last 3x3x3 stride-1 convolution probe for Hopper (sm_90a), bound
// with ctypes.
//
//   out[n, h, w, d, o] = bias[o] + sum_{dh, dw, dp, c} x[n, h + dh - 1, w + dw - 1,
//                                                      d + dp - 1, c] * k[dh, dw, dp, c, o]
//
// on x (N, H, W, D, C), k (3, 3, 3, C, O) (HWDIO) and zero padding 1; bf16
// operands with f32 sums stored as bf16, or f32 throughout (FMA).
//
// Replaces two TPU kernels, which compute this function:
//   experiments/pallas_conv_prototype.py `pallas_conv` -> `kernel` (pallas_call
//     at :90): a pre-built halo tile, 27 dots over shifted slices of it. Its
//     depth-parity fold (D pairs into 2C lanes, `build_w`) filled the TPU's
//     128 lanes at twice the FLOPs; it is not carried over: on the H100 a
//     channel count of 32 already fills an MMA's K.
//   experiments/pallas_conv_retired.py `packed_conv3d_stride1_pallas` ->
//     `_kernel` (pallas_call at :149): the tile flattened to rows, each
//     (dh, dw) tap a row offset that is a multiple of D, and three
//     depth-shifted copies staged so that no tap reads at an offset of one
//     row, which the TPU could not do. They are not carried over: here a
//     one-row shift of the swizzled halo tile costs no more than an aligned
//     read, and the copies tripled the staging (3.0 ms against the halo
//     tile's 1.25 ms on an H100, PERF.md section 6). Its outputs for the W
//     halo columns (computed and thrown away on the TPU) are not computed.
//
// What bounds it on this card: operations at C = O = 64 or more (27 C
// products per output value, ~800 FLOP per compulsory byte in bf16).
//
// bf16 (`conv_mma`): an implicit GEMM that keeps the tensor cores fed from
// shared memory, the conv unit's design (csrc/conv_unit.cu) on channels-last
// data, with the staging made asynchronous.
// * Persistent grid, one block per SM; block b walks the work items b,
//   b + G, ...: an output tile of 4 (h) x 4 (w) x 32 (d) = 512 positions
//   and 64 output channels. Ragged edges are zero-filled on the way in and
//   masked on the way out, so H, W and D are free.
// * Halo: per chunk of 32 input channels the block stages the tile's
//   6 x 6 x 34 halo (1,224 positions, 2.39 per output) as 64-byte rows,
//   swizzled by `ltu::swz`, with 16-byte `cp.async` copies that zero-fill
//   the padding (channels-last: each copy is 8 channels of one position).
//   Two buffers: chunk s + 1 (the next chunk, or the next tile's first)
//   lands while chunk s's MMAs run.
// * Weights: the wrapper packs them once per call into bf16 [output group
//   of 64][chunk][kh, kd][kw][64 outputs][32 channels], each output's 32
//   channels a 64-byte row, K-major, swizzled as `ltu::swz` (the hardware's
//   64-byte swizzle). Per (chunk, kh, kd) the three kw taps' 12 KB go
//   through a four-slot ring of bulk copies (TMA) on mbarriers: two slots
//   in flight ahead of the one being read, the fourth still read by the
//   previous group's last `wgmma`s. A tile reads each weight once per chunk,
//   not once per 128 outputs as the first probe did (0.8 GB of L2 traffic a
//   call at the main shape, from 2.6).
// * MMA: `wgmma` m64n64k16, A from registers, B from the slot by
//   descriptor (ltu::wgmma_m64n64k16). Warp w owns the 16 positions along d
//   starting at 16 (w % 2) at h row w / 2, in each of the tile's 4 w
//   columns; the four warps of a warpgroup make one 64-row A tile a column,
//   all 64 outputs (4 x 32 f32 accumulators a thread). Per (kh, kd) and 16
//   channels a warp loads the 6 halo columns' A fragments once (`ldmatrix`
//   at shifted rows, the m16n8k16 A layout that a register-A `wgmma` takes
//   warp by warp) and uses each for up to three kw taps: 12 `wgmma`s a
//   commit, two commits a group, each waited for only when its fragment
//   registers are loaded again, a group later (`wgmma_wait<1>`), so the
//   tensor cores run on across the groups' barriers.
// * Tried on the H100 and lost (PERF.md section 6, PR 10): waiting for each
//   step before the next (6-7% slower), one wait a group (5% slower), the
//   halo's copies spread over six groups between a step's issue and its wait
//   (10-11% slower), and per-slot release barriers in place of the block
//   barrier between groups (5% slower).
// * Epilogue: bias, rounding to bf16 through shared memory (the tile's
//   spent halo buffer), then 16-byte channels-last stores.
//
// f32 (`conv_fma`): a block owns 1 x (128 / D) x D outputs and 64 or 128
// output channels; per 16-channel chunk it stages its halo once (row stride
// 17 floats) and the weights of one dh at a time; one thread per position
// and half the block's output channels, FMA in f32.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores
// ---------------------------------------------------------------------------

constexpr int kTH = 4, kTW = 4, kTD = 32;                  // output tile
constexpr int kHH = kTH + 2, kHW = kTW + 2, kHD = kTD + 2;  // its halo
constexpr int kHalo = kHH * kHW * kHD;                     // staged positions
constexpr int kM = kTH * kTW * kTD;                        // output positions
constexpr int kNT = 64;                                    // outputs per work item
constexpr int kKC = 32;                                    // channels per chunk
constexpr int kCpr = kKC / 8;                              // 16-byte pieces a halo row
constexpr int kGroups = 9;                                 // (kh, kd) slots per chunk
constexpr int kTapElems = kNT * kKC;                       // one tap's weights of a chunk
constexpr int kSlotElems = 3 * kTapElems;                  // the three kw taps
constexpr int kSlots = 4;
// slots in flight ahead of the one read: the previous group's last step may
// still read its own
constexpr int kLookahead = kSlots - 2;
constexpr size_t kHaloBytes = ltu::align_up(sizeof(bf16) * kHalo * kKC, 1024);
constexpr size_t kRingOffset = 2 * kHaloBytes;
constexpr size_t kBarOffset = kRingOffset + kSlots * sizeof(bf16) * kSlotElems;
constexpr size_t kMmaSmem = kBarOffset + kSlots * sizeof(unsigned long long);

static_assert(kWarps == 2 * kTH && kTD == 32, "warp w: h row w / 2, 16 d from 16 (w % 2)");
static_assert(sizeof(bf16) * kM * kNT <= kHaloBytes, "the epilogue fits in a halo buffer");
static_assert(kMmaSmem <= kSmemLimit, "shared memory");

struct MmaArgs {
  const bf16* x;      // (N, H, W, D, C)
  const bf16* w;      // packed, see above
  const float* bias;  // (O,) or null
  bf16* out;          // (N, H, W, D, O)
  int n, h, w_, d, c, o;
  int tiles_h, tiles_w, tiles_d, groups, chunks, items;
};

struct Item {
  int n, h0, w0, d0, og;
};

__device__ __forceinline__ Item item_at(const MmaArgs& a, int item) {
  Item it;
  it.og = item % a.groups;
  int t = item / a.groups;
  it.d0 = (t % a.tiles_d) * kTD;
  t /= a.tiles_d;
  it.w0 = (t % a.tiles_w) * kTW;
  t /= a.tiles_w;
  it.h0 = (t % a.tiles_h) * kTH;
  it.n = t / a.tiles_h;
  return it;
}

// Chunk `ch` of the item's halo into `buf`, row (hh, ww, dd) at position
// (h0 + hh - 1, w0 + ww - 1, d0 + dd - 1); zeros outside the volume. One
// commit group per thread.
__device__ __forceinline__ void stage_halo(bf16* buf, const MmaArgs& a, const Item& it, int ch,
                                           int tid) {
  const bf16* x = a.x + ch * kKC;
  for (int i = tid; i < kHalo * kCpr; i += kThreads) {
    const int piece = i % kCpr, pos = i / kCpr;
    const int dd = pos % kHD, r = pos / kHD;
    const int gh = it.h0 + r / kHW - 1, gw = it.w0 + r % kHW - 1, gd = it.d0 + dd - 1;
    const bool inside = gh >= 0 && gh < a.h && gw >= 0 && gw < a.w_ && gd >= 0 && gd < a.d;
    const bf16* src =
        inside ? x + (((static_cast<long long>(it.n) * a.h + gh) * a.w_ + gw) * a.d + gd) * a.c +
                     piece * 8
               : a.x;
    ltu::cp_async16_zfill(buf + ltu::swz(pos, piece, kCpr), src, inside);
  }
  ltu::cp_async_commit();
}

// The block's weight slots in order: slot g is (stage g / 9, (kh, kd) =
// g % 9); stage s is chunk s % chunks of the block's item s / chunks.
struct Ring {
  bf16* slots;
  unsigned long long* full;
  const bf16* w;
  int chunks, groups;
  int n_slots;  // the block's total

  __device__ __forceinline__ void issue(int g) const {
    if (g >= n_slots) return;
    const int s = g / kGroups, grp = g % kGroups;
    const int item = blockIdx.x + (s / chunks) * gridDim.x;
    const int og = item % groups, ch = s % chunks;
    const bf16* src = w + (static_cast<size_t>(og * chunks + ch) * kGroups + grp) * kSlotElems;
    unsigned long long* bar = full + g % kSlots;
    ltu::mbar_expect_tx(bar, sizeof(bf16) * kSlotElems);
    ltu::bulk_copy(slots + (g % kSlots) * kSlotElems, src, sizeof(bf16) * kSlotElems, bar);
  }
};

// The A fragments of chunk step ks (16 channels) for halo columns 0..5 of
// the warp's rows, from row r0 (`ldmatrix` at any row).
__device__ __forceinline__ void load_a(unsigned (&af)[kHW][4], const bf16* halo, int r0, int ks,
                                       int lane) {
#pragma unroll
  for (int c = 0; c < kHW; ++c) {
    ltu::ldsm_x4(af[c], halo + ltu::swz(r0 + c * kHD, ks * 2 + (lane >> 4), kCpr));
  }
}

// acc[j] += step ks of the three kw taps in `slot` for the warpgroup's
// 64-row A tile j (output column j, each warp's 16 rows): column j of tap
// kw reads halo column j + kw. One commit group of 12 `wgmma`s.
__device__ __forceinline__ void issue_step(float (&acc)[kTW][kNT / 2],
                                           const unsigned (&af)[kHW][4], const bf16* slot,
                                           int ks) {
  ltu::wgmma_fence();
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const unsigned long long desc =
        ltu::wgmma_desc_kmajor(slot + kw * kTapElems, 2 * kKC) + ks * 2;  // + 32 bytes a k16
#pragma unroll
    for (int j = 0; j < kTW; ++j) ltu::wgmma_m64n64k16(acc[j], af[j + kw], desc);
  }
  ltu::wgmma_commit();
}

// One (kh, kd) group over the chunk's 32 channels, two commit groups. On
// return this group's second step may still run: the caller's next group
// waits for it before it reloads af1, and the ring rewrites a slot only two
// groups after its last read.
__device__ __forceinline__ void mma_group(float (&acc)[kTW][kNT / 2], const bf16* halo,
                                          const bf16* slot, int kh, int kd, int warp, int lane) {
  const int r0 = (warp / 2 + kh) * kHW * kHD + (warp % 2) * 16 + kd + (lane & 15);
  unsigned af0[kHW][4], af1[kHW][4];
  load_a(af0, halo, r0, 0, lane);  // the previous group's first step is done
  issue_step(acc, af0, slot, 0);
  ltu::wgmma_wait<1>();            // the previous group's second step is done
  load_a(af1, halo, r0, 1, lane);
  issue_step(acc, af1, slot, 1);
  ltu::wgmma_wait<1>();            // this group's first step is done
}

__device__ __forceinline__ void wait_acc(float (&acc)[kTW][kNT / 2]) {
  ltu::wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < kTW; ++j) ltu::wgmma_fence_operand(acc[j]);
}

// Bias, rounding to bf16 into s_out ([512 positions][64 outputs], 128-byte
// rows, swizzled), then 16-byte stores of the positions inside the volume.
__device__ __forceinline__ void epilogue(const float (&acc)[kTW][kNT / 2], bf16* s_out,
                                         const MmaArgs& a, const Item& it, int tid, int warp,
                                         int lane) {
  const int o0 = it.og * kNT;
#pragma unroll
  for (int t = 0; t < kNT / 8; ++t) {
    const int o = t * 8 + 2 * (lane & 3);
    const float b0 = a.bias != nullptr ? __ldg(a.bias + o0 + o) : 0.f;
    const float b1 = a.bias != nullptr ? __ldg(a.bias + o0 + o + 1) : 0.f;
#pragma unroll
    for (int j = 0; j < kTW; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pos = ((warp / 2) * kTW + j) * kTD + (warp % 2) * 16 + (lane >> 2) + 8 * hh;
        *reinterpret_cast<unsigned*>(s_out + ltu::swz(pos, t, kNT / 8) + 2 * (lane & 3)) =
            ltu::pack_bf16x2(acc[j][4 * t + 2 * hh] + b0, acc[j][4 * t + 2 * hh + 1] + b1);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kM * (kNT / 8); i += kThreads) {
    const int piece = i % (kNT / 8), pos = i / (kNT / 8);
    const int gd = it.d0 + pos % kTD, gw = it.w0 + (pos / kTD) % kTW;
    const int gh = it.h0 + pos / (kTD * kTW);
    if (gh >= a.h || gw >= a.w_ || gd >= a.d) continue;
    *reinterpret_cast<uint4*>(
        a.out + (((static_cast<long long>(it.n) * a.h + gh) * a.w_ + gw) * a.d + gd) * a.o + o0 +
        piece * 8) = *reinterpret_cast<const uint4*>(s_out + ltu::swz(pos, piece, kNT / 8));
  }
}

__global__ void __launch_bounds__(kThreads, 1) conv_mma(const MmaArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  auto halo = [&](int s) { return reinterpret_cast<bf16*>(smem + (s & 1) * kHaloBytes); };
  const int items = (a.items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int stages = items * a.chunks;
  const Ring ring{reinterpret_cast<bf16*>(smem + kRingOffset),
                  reinterpret_cast<unsigned long long*>(smem + kBarOffset), a.w, a.chunks,
                  a.groups, stages * kGroups};
  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) ltu::mbar_init(ring.full + i, 1);
    ltu::fence_mbar_init();
    for (int g = 0; g < kLookahead; ++g) ring.issue(g);
  }
  if (stages > 0) stage_halo(halo(0), a, item_at(a, blockIdx.x), 0, tid);
  __syncthreads();  // the barriers are initialised

  float acc[kTW][kNT / 2];
  for (int s = 0; s < stages; ++s) {
    const int ch = s % a.chunks;
    const Item it = item_at(a, blockIdx.x + (s / a.chunks) * gridDim.x);
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < kTW; ++j) {
#pragma unroll
        for (int q = 0; q < kNT / 2; ++q) acc[j][q] = 0.f;
      }
    }
    for (int grp = 0; grp < kGroups; ++grp) {
      const int g = s * kGroups + grp;
      if (grp == 0) ltu::cp_async_wait_all();  // this stage's halo, own copies
      ltu::mbar_wait(ring.full + g % kSlots, (g / kSlots) & 1);
      // every thread's halo copies have landed, the block is done with slot
      // g - 2 and (at grp 0) with the other halo buffer
      __syncthreads();
      if (tid == 0) {
        ltu::fence_proxy_async();  // the block's earlier accesses come before the copy
        ring.issue(g + kLookahead);
      }
      if (grp == 0 && s + 1 < stages) {
        const int s1 = s + 1;
        stage_halo(halo(s1), a, item_at(a, blockIdx.x + (s1 / a.chunks) * gridDim.x),
                   s1 % a.chunks, tid);
      }
      mma_group(acc, halo(s), ring.slots + (g % kSlots) * kSlotElems, grp / 3, grp % 3, warp,
                lane);
    }
    if (ch == a.chunks - 1) {
      wait_acc(acc);
      __syncthreads();  // the halo buffer's readers are done
      epilogue(acc, halo(s), a, it, tid, warp, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 operands: FMA
// ---------------------------------------------------------------------------

constexpr int kFM = 128;        // output positions per block: 1 x (128 / D) x D
constexpr int kFKC = 16;        // input channels per chunk
constexpr int kFStride = 17;    // floats per staged row: no bank conflicts

struct FmaArgs {
  const float* x;
  const float* k;     // (27, C, O)
  const float* bias;  // (O,) or null
  float* out;
  int n, h, w, d, c, o, tw;
};

__host__ __device__ inline int fma_positions(int d, int tw) { return 3 * (tw + 2) * (d + 2); }

__host__ __device__ inline size_t fma_smem_bytes(int d, int tw, int nt) {
  return ltu::align_up(sizeof(float) * fma_positions(d, tw) * kFStride, 128) +
         sizeof(float) * 9 * kFKC * nt;
}

template <int NT>
__global__ void __launch_bounds__(kThreads) conv_fma(const FmaArgs a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int OPT = NT / 2;
  const int P = fma_positions(a.d, a.tw);
  float* s_in = reinterpret_cast<float*>(smem);
  float* s_w = reinterpret_cast<float*>(
      smem + ltu::align_up(sizeof(float) * P * kFStride, 128));

  const int tiles_w = a.w / a.tw;
  const int h0 = blockIdx.x / tiles_w;
  const int w0 = (blockIdx.x % tiles_w) * a.tw;
  const int n = blockIdx.y;
  const int o0 = blockIdx.z * NT;
  const int tid = threadIdx.x;
  const int m = tid % kFM, og = tid / kFM;
  const int dl = m % a.d, wl = m / a.d;
  float facc[OPT];
#pragma unroll
  for (int j = 0; j < OPT; ++j) facc[j] = 0.f;

  for (int c0 = 0; c0 < a.c; c0 += kFKC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < P * 4; i += kThreads) {
      const int piece = i % 4, pos = i / 4;
      const int dd = pos % (a.d + 2), r = pos / (a.d + 2);
      const int gw = w0 + r % (a.tw + 2) - 1, gh = h0 + r / (a.tw + 2) - 1, gd = dd - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gh >= 0 && gh < a.h && gw >= 0 && gw < a.w && gd >= 0 && gd < a.d) {
        v = *reinterpret_cast<const float4*>(
            a.x + (((static_cast<long long>(n) * a.h + gh) * a.w + gw) * a.d + gd) * a.c + c0 +
            piece * 4);
      }
      float* dst = s_in + pos * kFStride + piece * 4;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    for (int kh = 0; kh < 3; ++kh) {
      if (kh) __syncthreads();  // the previous dh's weights are read
      // weights of the 9 taps of this dh, channels [c0, c0 + 16), outputs [o0, o0 + NT)
      for (int i = tid; i < 9 * kFKC * (NT / 4); i += kThreads) {
        const int piece = i % (NT / 4);
        const int k = (i / (NT / 4)) % kFKC;
        const int j = i / ((NT / 4) * kFKC);
        *reinterpret_cast<float4*>(s_w + (j * kFKC + k) * NT + piece * 4) =
            *reinterpret_cast<const float4*>(
                a.k + (static_cast<long long>(kh * 9 + j) * a.c + c0 + k) * a.o + o0 + piece * 4);
      }
      __syncthreads();
      for (int j = 0; j < 9; ++j) {
        const int kw = j / 3, kd = j % 3;
        const float* ar = s_in + (((kh) * (a.tw + 2) + wl + kw) * (a.d + 2) + dl + kd) * kFStride;
        const float* wr = s_w + j * kFKC * NT + og * OPT;
#pragma unroll 4
        for (int k = 0; k < kFKC; ++k) {
          const float av = ar[k];
#pragma unroll
          for (int q = 0; q < OPT; q += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(wr + k * NT + q);
            facc[q] += av * wv.x;
            facc[q + 1] += av * wv.y;
            facc[q + 2] += av * wv.z;
            facc[q + 3] += av * wv.w;
          }
        }
      }
    }
  }

  float* dst = a.out + ((((static_cast<long long>(n) * a.h + h0) * a.w + w0 + wl) * a.d + dl) *
                        a.o) + o0 + og * OPT;
#pragma unroll
  for (int q = 0; q < OPT; ++q) dst[q] = facc[q] + (a.bias ? a.bias[o0 + og * OPT + q] : 0.f);
}

template <int NT>
int launch_fma(const FmaArgs& a, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(a.d, a.tw, NT);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv_fma<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.h * (a.w / a.tw), a.n, a.o / NT);
  conv_fma<NT><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(MmaArgs a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kMmaSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.tiles_h = (a.h + kTH - 1) / kTH;
  a.tiles_w = (a.w_ + kTW - 1) / kTW;
  a.tiles_d = (a.d + kTD - 1) / kTD;
  a.groups = a.o / kNT;
  a.chunks = a.c / kKC;
  const long long items =
      static_cast<long long>(a.n) * a.tiles_h * a.tiles_w * a.tiles_d * a.groups;
  if (items > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  a.items = static_cast<int>(items);
  const int grid = a.items < sms ? a.items : sms;
  conv_mma<<<grid, kThreads, kMmaSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One warpgroup: out (64 x N, f32) = a (64 x k, bf16, row-major) times B,
// given K-major as bt (N x k, bf16), by `ltu::wgmma_m64k16<N>`: A from
// registers (`ldmatrix`), B staged in tiles of N rows of `row_bytes` (64 or
// 128) bytes, zeros past k, and read at k / 16 descriptor steps. The card
// test of each `wgmma` width alone (the conv takes N 64, the tap sums 16, 32,
// 64 and 128). `halves` (N 128): each k16 step also adds B's first 64 rows'
// product into columns 0..63 and its last 64 rows' into columns 64..127 by
// m64n64k16 on each half of the m64n128 accumulator (the inner-loop probe's
// neighbour taps), so out is twice a times B.
template <int N>
__global__ void __launch_bounds__(128) wgmma_product(const bf16* a, const bf16* bt, float* out,
                                                     int k, int row_bytes, int halves) {
  __shared__ __align__(1024) bf16 s_a[64 * 64];
  __shared__ __align__(1024) bf16 s_b[N * 64];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cpr = row_bytes / 16, k_tile = row_bytes / 2;
  for (int i = tid; i < (64 + N) * 8; i += 128) {
    const int r = i / 8, piece = i % 8;
    const bool is_a = r < 64;
    const int row = is_a ? r : r - 64;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (piece * 8 < k) v = *reinterpret_cast<const uint4*>((is_a ? a : bt) + row * k + piece * 8);
    if (is_a) {
      *reinterpret_cast<uint4*>(s_a + ltu::swz(row, piece, 8)) = v;
    } else {
      *reinterpret_cast<uint4*>(s_b + (piece / cpr) * N * k_tile +
                                ltu::swz(row, piece % cpr, cpr)) = v;
    }
  }
  ltu::fence_proxy_async();  // the stores of B come before the tensor cores' reads
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int step = 0; step < k / 16; ++step) {
    unsigned af[4];
    ltu::ldsm_x4(af, s_a + ltu::swz(warp * 16 + (lane & 15), step * 2 + (lane >> 4), 8));
    const int byte = step * 32;
    const unsigned long long desc =
        ltu::wgmma_desc_kmajor(s_b + (byte / row_bytes) * N * k_tile, row_bytes) +
        ((byte % row_bytes) >> 4);
    ltu::wgmma_fence();
    ltu::wgmma_m64k16<N>(d, af, desc);
    if constexpr (N == 128) {
      if (halves) {
        const unsigned long long lower = desc + ((64 * row_bytes) >> 4);  // B's rows 64 ..
        ltu::wgmma_m64n64k16<0>(d, af, desc);
        ltu::wgmma_m64n64k16<32>(d, af, lower);
      }
    }
    ltu::wgmma_commit();
    ltu::wgmma_wait<0>();
    ltu::wgmma_fence_operand(d);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
    out[row * N + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)] = d[i];
  }
}

}  // namespace

extern "C" {

// out (64, n) f32 = a (64, k) @ bt (n, k)^T, bf16 operands, on one
// warpgroup by `wgmma` m64nNk16 (`wgmma_product`); n in {16, 32, 64, 128},
// k in {16, 32, 48, 64}, row_bytes 64 or 128; with halves (n 128 only) out
// is twice the product, its second half added by m64n64k16 into each half
// of the accumulator. Returns the CUDA error (0 on success).
int pc_wgmma_product(const void* a, const void* bt, void* out, int n, int k, int row_bytes,
                     int halves, void* stream) {
  if (k < 16 || k > 64 || k % 16 || (row_bytes != 64 && row_bytes != 128) ||
      (halves && n != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const bf16*>(a);
  auto pb = static_cast<const bf16*>(bt);
  auto po = static_cast<float*>(out);
  switch (n) {
    case 16: wgmma_product<16><<<1, 128, 0, s>>>(pa, pb, po, k, row_bytes, halves); break;
    case 32: wgmma_product<32><<<1, 128, 0, s>>>(pa, pb, po, k, row_bytes, halves); break;
    case 64: wgmma_product<64><<<1, 128, 0, s>>>(pa, pb, po, k, row_bytes, halves); break;
    case 128: wgmma_product<128><<<1, 128, 0, s>>>(pa, pb, po, k, row_bytes, halves); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x (n, h, w, d, c) and out (n, h, w, d, o) channels-last, contiguous, of one
// dtype; bias (o,) f32 or null. bf16 (is_bf16): k packed as
// `conv_prototype.pack_weights` packs it, c % 32 == 0, o % 64 == 0, any h,
// w, d. f32: k (3, 3, 3, c, o) contiguous, d in {16, 32, 64, 128}, (128 / d)
// | w, c % 16 == 0, o % 64 == 0. Returns the CUDA error (0 on success).
int pc_forward(const void* x, const void* k, const void* bias, void* out, int n, int h, int w,
               int d, int c, int o, int is_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (c % kKC || o % kNT || n < 1 || h < 1 || w < 1 || d < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    MmaArgs a{};
    a.x = static_cast<const bf16*>(x);
    a.w = static_cast<const bf16*>(k);
    a.bias = static_cast<const float*>(bias);
    a.out = static_cast<bf16*>(out);
    a.n = n, a.h = h, a.w_ = w, a.d = d, a.c = c, a.o = o;
    return launch_mma(a, s);
  }
  if (d % 16 || kFM % d || w % (kFM / d) || c % kFKC || o % 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FmaArgs a{static_cast<const float*>(x), static_cast<const float*>(k),
                  static_cast<const float*>(bias), static_cast<float*>(out), n, h, w, d, c, o,
                  kFM / d};
  return a.o % 128 == 0 ? launch_fma<128>(a, s) : launch_fma<64>(a, s);
}

}  // extern "C"
