// Stride-1 3x3x3 convolution unit for Hopper (sm_90a), bound with ctypes.
//
// On contiguous (N, C, H, W, D) activations and (O, C, 3, 3, 3) f32 weights
// it computes, per volume n:
//
//   a   = act(xa * scale_a[n, c] + shift_a[n, c]), act = LeakyReLU(0.01),
//         or xa itself without an affine; 0 outside the volume (the conv's
//         zero padding applies to the activation, not to xa)
//   b   = the same for the optional second input xb (the UpBlock concat)
//   y   = bias + conv(a, wa) + conv(b, wb), stored in the input dtype
//   stats[n, 0, o] = sum of y as stored, stats[n, 1, o] = sum of y^2 (f32)
//   z   = a (optional)
//
// The input and output dtype TI is bf16 or f32; operands are rounded to the
// compute dtype TC (bf16 or f32) when they are staged in shared memory, and
// products are summed in f32. The model's callers take TC = bf16 whatever
// TI is, as the TPU kernel's `compute_dtype` default does.
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
// ones with 16 outputs by bytes. This first design is an implicit GEMM
// that keeps things simple and right, far from either bound:
//
// * A block takes 2 (w) x 64 (d) output voxels at one h (M = 128) and 16 or
//   32 output channels. Input channels go through in chunks of 16: the
//   block stages a 3 x 4 x 66 halo of the chunk into shared memory with the
//   prologue already applied (zeros outside the volume), and the chunk's
//   27 x 16 x NT weights rounded to the operand dtype.
// * bf16: each warp owns 16 voxels along d and runs, for each of the 27
//   taps, one 16x16x16 WMMA product per 16 output channels (f32
//   accumulators). The halo is stored channels-last, so the A tile of tap
//   (kh, kw, kd) is a row-major 16 x 16 view at a shifted row. f32: one
//   thread per voxel and 8 or 16 output channels, FMA in f32.
// * Epilogue: bias, rounding to the output dtype, the store, and per-block
//   sums of the stored values per channel. No float atomics: every block
//   writes its partial sums and `stats_reduce` adds them in a fixed order,
//   so the statistics are the same from run to run.
// * wgmma/TMA, channels-last storage and a persistent schedule are left
//   for the PRs that make the kernel fast.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using ltu::from_f32;
using ltu::to_f32;
using ltu::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 2;                       // output w positions per block
constexpr int kTD = 64;                      // output d positions per block
constexpr int kM = kTW * kTD;                // output voxels per block
constexpr int kKC = 16;                      // input channels per chunk
constexpr int kHaloW = kTW + 2;
constexpr int kHaloD = kTD + 2;
constexpr int kHalo = 3 * kHaloW * kHaloD;   // halo positions per channel
constexpr float kSlope = 0.01f;              // LeakyReLU negative slope

static_assert(kM == kWarps * 16, "one 16-voxel WMMA row tile per warp");
static_assert(kTD % 16 == 0, "a warp's 16 voxels lie at one w");

// Channel stride of the staged halo: 16 for the WMMA path (A tiles are
// 16 x 16 row-major, 32-byte aligned), 17 for the f32 path so that
// neighbouring voxels fall in different banks.
template <typename T>
__host__ __device__ constexpr int halo_cstride() {
  return std::is_same<T, float>::value ? kKC + 1 : kKC;
}

template <typename TC, int NT>
__host__ __device__ constexpr size_t weights_offset() {
  return ltu::align_up(sizeof(TC) * kHalo * halo_cstride<TC>(), 128);
}

template <typename TC, int NT>
__host__ __device__ constexpr size_t smem_bytes() {
  return weights_offset<TC, NT>() + sizeof(TC) * 27 * kKC * NT;
}

struct Input {
  const void* x;         // (N, C, H, W, D), TI
  const float* w;        // element (o, c, tap) at w[(o * cstride + c) * 27 + tap]
  int cstride;
  const float* affine;   // (N, 2, C) f32 scale, shift; or null
  int c;                 // channels
};

template <typename TI, typename TC, int NT>
__global__ void __launch_bounds__(kThreads)
conv_unit_kernel(Input in_a, Input in_b, const float* __restrict__ bias,
                 TI* __restrict__ y, TI* __restrict__ z, float* __restrict__ part,
                 int n_out, int H, int W, int D, int tiles_w, int tiles_d) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int CS = halo_cstride<TC>();
  TC* s_in = reinterpret_cast<TC*>(smem);
  TC* s_w = reinterpret_cast<TC*>(smem + weights_offset<TC, NT>());
  float* s_out = reinterpret_cast<float*>(smem);  // reuses s_in after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int t = blockIdx.x;
  const int td = t % tiles_d;
  t /= tiles_d;
  const int tw = t % tiles_w;
  const int h = t / tiles_w;
  const int w0 = tw * kTW;
  const int d0 = td * kTD;
  const int n = blockIdx.y;
  const int o0 = blockIdx.z * NT;
  const size_t plane = static_cast<size_t>(H) * W * D;

  // bf16 accumulators: warp -> voxels [warp * 16, warp * 16 + 16)
  using namespace nvcuda;
  constexpr bool kMma = std::is_same<TC, __nv_bfloat16>::value;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_mma[NT / 16];
  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < NT / 16; ++j) wmma::fill_fragment(acc_mma[j], 0.f);
  }
  // f32: thread -> voxel tid % kM, channels (tid / kM) * OPT + [0, OPT)
  constexpr int OPT = NT * kM / kThreads;
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
      for (int idx = tid; idx < kKC * kHalo; idx += kThreads) {
        const int dd = idx % kHaloD;
        int r = idx / kHaloD;
        const int ww = r % kHaloW;
        r /= kHaloW;
        const int hh = r % 3;
        const int c = r / 3;
        const int gc = c0 + c, gh = h + hh - 1, gw = w0 + ww - 1, gd = d0 + dd - 1;
        float v = 0.f;
        if (gc < in.c && gh >= 0 && gh < H && gw >= 0 && gw < W && gd >= 0 && gd < D) {
          v = to_f32(x[(static_cast<size_t>(n) * in.c + gc) * plane +
                       (static_cast<size_t>(gh) * W + gw) * D + gd]);
          if (in.affine != nullptr) {
            // a multiply and an add, each rounded, as the plain version's
            // two ops: a fused multiply-add would move some values across a
            // bf16 rounding boundary and the operand by a bf16 ulp
            v = __fadd_rn(__fmul_rn(v, in.affine[(n * 2) * in.c + gc]),
                          in.affine[(n * 2 + 1) * in.c + gc]);
            v = v >= 0.f ? v : v * kSlope;
          }
        }
        s_in[((hh * kHaloW + ww) * kHaloD + dd) * CS + c] = from_f32<TC>(v);
      }
      // weights of the chunk: s_w[tap][c][o], rounded to TC, zero-padded
      for (int idx = tid; idx < NT * kKC * 27; idx += kThreads) {
        const int tap = idx % 27;
        const int c = (idx / 27) % kKC;
        const int o = idx / (27 * kKC);
        const int gc = c0 + c, go = o0 + o;
        const float v = (gc < in.c && go < n_out)
            ? in.w[(static_cast<size_t>(go) * in.cstride + gc) * 27 + tap] : 0.f;
        s_w[(tap * kKC + c) * NT + o] = from_f32<TC>(v);
      }
      __syncthreads();

      if (z != nullptr && src == 0 && blockIdx.z == 0) {
        // z = the prologued input as rounded to TC, at the block's own voxels
        for (int idx = tid; idx < kKC * kM; idx += kThreads) {
          const int dd = idx % kTD;
          const int ww = (idx / kTD) % kTW;
          const int c = idx / kM;
          const int gc = c0 + c, gw = w0 + ww, gd = d0 + dd;
          if (gc < in.c && gw < W && gd < D) {
            z[(static_cast<size_t>(n) * in.c + gc) * plane +
              (static_cast<size_t>(h) * W + gw) * D + gd] = from_f32<TI>(
                to_f32(s_in[((1 * kHaloW + ww + 1) * kHaloD + dd + 1) * CS + c]));
          }
        }
      }

      if constexpr (kMma) {
        const int m0 = warp * 16;
        const int wl = m0 / kTD;
        const int dl0 = m0 % kTD;
        for (int kh = 0; kh < 3; ++kh) {
          for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
            for (int kd = 0; kd < 3; ++kd) {
              const int tap = (kh * 3 + kw) * 3 + kd;
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
              wmma::load_matrix_sync(
                  a, s_in + ((kh * kHaloW + wl + kw) * kHaloD + dl0 + kd) * CS, CS);
#pragma unroll
              for (int j = 0; j < NT / 16; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
                wmma::load_matrix_sync(b, s_w + tap * kKC * NT + j * 16, NT);
                wmma::mma_sync(acc_mma[j], a, b, acc_mma[j]);
              }
            }
          }
        }
      } else {
        const int m = tid % kM;
        const int og = tid / kM;
        const int wl = m / kTD;
        const int dl = m % kTD;
        for (int kh = 0; kh < 3; ++kh) {
          for (int kw = 0; kw < 3; ++kw) {
            for (int kd = 0; kd < 3; ++kd) {
              const int tap = (kh * 3 + kw) * 3 + kd;
              const TC* a_row = s_in + ((kh * kHaloW + wl + kw) * kHaloD + dl + kd) * CS;
              const TC* w_row = s_w + tap * kKC * NT + og * OPT;
#pragma unroll 4
              for (int c = 0; c < kKC; ++c) {
                const float a = to_f32(a_row[c]);
#pragma unroll
                for (int j = 0; j < OPT; ++j) acc[j] += a * to_f32(w_row[c * NT + j]);
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();  // s_in is reused as s_out below

  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < NT / 16; ++j) {
      wmma::store_matrix_sync(s_out + warp * 16 * NT + j * 16, acc_mma[j], NT,
                              wmma::mem_row_major);
    }
  } else {
    const int m = tid % kM;
    const int og = tid / kM;
#pragma unroll
    for (int j = 0; j < OPT; ++j) s_out[m * NT + og * OPT + j] = acc[j];
  }
  __syncthreads();

  // bias, round, store; keep the stored value (0 off the volume) for stats
  for (int idx = tid; idx < NT * kM; idx += kThreads) {
    const int o = idx / kM;
    const int m = idx % kM;
    const int go = o0 + o, gw = w0 + m / kTD, gd = d0 + m % kTD;
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
    for (int m = lane; m < kM; m += 32) {
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

template <typename TI, typename TC, int NT>
int launch(const Input& a, const Input& b, const float* bias, void* y, void* z,
           float* part, float* stats, int n, int n_out, int H, int W, int D,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<TC, NT>();
  cudaError_t err = cudaFuncSetAttribute(
      conv_unit_kernel<TI, TC, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_d = (D + kTD - 1) / kTD;
  const int tiles = H * tiles_w * tiles_d;
  const dim3 grid(tiles, n, (n_out + NT - 1) / NT);
  conv_unit_kernel<TI, TC, NT><<<grid, kThreads, smem, stream>>>(
      a, b, bias, static_cast<TI*>(y), static_cast<TI*>(z), part, n_out, H, W, D,
      tiles_w, tiles_d);
  err = cudaGetLastError();
  if (err != cudaSuccess || stats == nullptr) return static_cast<int>(err);
  stats_reduce<<<dim3(n, 2 * n_out), kThreads, 0, stream>>>(part, stats, tiles, n_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI, typename TC>
int dispatch(const Input& a, const Input& b, const float* bias, void* y, void* z,
             float* part, float* stats, int n, int n_out, int H, int W, int D,
             cudaStream_t stream) {
  if (n_out <= 16) {
    return launch<TI, TC, 16>(a, b, bias, y, z, part, stats, n, n_out, H, W, D, stream);
  }
  return launch<TI, TC, 32>(a, b, bias, y, z, part, stats, n, n_out, H, W, D, stream);
}

}  // namespace

extern "C" {

// Output tiles per volume: the number of partial sums the wrapper allocates
// per volume and channel for the statistics.
int cu_num_tiles(int h, int w, int d) {
  return h * ((w + kTW - 1) / kTW) * ((d + kTD - 1) / kTD);
}

// xa (n, ca, h, w, d) and optional xb (n, cb, h, w, d): contiguous, f32
// (is_bf16 == 0) or bf16; y and z have that dtype. Operands are rounded to
// bf16 (compute_bf16 != 0) or f32. wa / wb: f32, element (o, c, tap) at
// w[(o * cstride + c) * 27 + tap]. aff_a / aff_b: (n, 2, c) f32 or null.
// bias: (n_out,) f32 or null. y: (n, n_out, h, w, d); z: like xa, or null.
// part: f32 scratch (n, cu_num_tiles, 2, n_out) and stats (n, 2, n_out),
// both null without statistics. Launches on `stream`; returns the CUDA
// error of the launches (0 on success).
int cu_forward(const void* xa, const void* wa, int wa_cstride, const void* aff_a, int ca,
               const void* xb, const void* wb, int wb_cstride, const void* aff_b, int cb,
               const void* bias, void* y, void* z, void* part, void* stats,
               int n, int n_out, int h, int w, int d, int is_bf16, int compute_bf16,
               void* stream) {
  const Input a{xa, static_cast<const float*>(wa), wa_cstride,
                static_cast<const float*>(aff_a), ca};
  const Input b{xb, static_cast<const float*>(wb), wb_cstride,
                static_cast<const float*>(aff_b), cb};
  const auto* bi = static_cast<const float*>(bias);
  auto* pa = static_cast<float*>(part);
  auto* st = static_cast<float*>(stats);
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (is_bf16 && compute_bf16) {
    return dispatch<bf16, bf16>(a, b, bi, y, z, pa, st, n, n_out, h, w, d, s);
  }
  if (is_bf16) return dispatch<bf16, float>(a, b, bi, y, z, pa, st, n, n_out, h, w, d, s);
  if (compute_bf16) return dispatch<float, bf16>(a, b, bi, y, z, pa, st, n, n_out, h, w, d, s);
  return dispatch<float, float>(a, b, bi, y, z, pa, st, n, n_out, h, w, d, s);
}

}  // extern "C"
