// Channels-last 3x3x3 stride-1 convolution probe for Hopper (sm_90a), in two
// staging designs, bound with ctypes.
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
//     channel count of 64 already fills an MMA's K.
//   experiments/pallas_conv_retired.py `packed_conv3d_stride1_pallas` ->
//     `_kernel` (pallas_call at :149): the tile flattened to rows, each
//     (dh, dw) tap a row offset that is a multiple of D, and three
//     depth-shifted copies staged so that no tap reads at an offset of one
//     row. Its outputs for the W halo columns (computed and thrown away on
//     the TPU) are not computed here: a warp's 16 rows lie at one (h, w).
//
// What bounds it on this card: operations at C = O = 64 or more (27 C
// products per output value, ~800 FLOP per compulsory byte in bf16). The
// design is simple and measurable, not fast:
//
// * A block owns th x tw x D output positions (th * tw * D = 128, 16 rows
//   per warp) and NT = 64 or 128 output channels. Input channels go through
//   in chunks of 64 bytes (32 bf16 or 16 f32).
// * `halo` (kRows = false): per chunk the block stages the (th + 2) x
//   (tw + 2) x (D + 2) halo once; tap (dh, dw, dp) reads the rows of the
//   warp's positions shifted by dp (one row), dw and dh.
// * `rows` (kRows = true): per chunk the block stages three copies of the
//   (th + 2) x (tw + 2) x D tile, copy dp holding depth d + dp - 1; tap
//   (dh, dw, dp) reads copy dp at a row offset that is a multiple of D.
// * bf16: `mma.sync` m16n8k16 through `ldmatrix` from XOR-swizzled tiles
//   (csrc/tensor_core.cuh), whose swizzle makes a one-row shift as cheap as
//   an aligned read; weights go through one dh (9 taps) at a time. f32: one
//   thread per position and half the block's output channels, FMA in f32
//   from a tile with a row stride of 17 floats.
// * No wgmma, TMA or pipelining: a later PR's work.

#include <type_traits>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kM = 128;            // output positions per block
constexpr int kChunkBytes = 64;    // input channels per chunk: 4 16-byte pieces
constexpr int kPieces = kChunkBytes / 16;
constexpr int kF32Stride = 17;     // floats per staged f32 row
constexpr int kSmemLimit = 232448;

struct ConvArgs {
  const void* x;
  const void* k;      // (27, C, O)
  const float* bias;  // (O,) or null
  void* out;
  int n, h, w, d, c, o;
  int th, tw;
};

template <typename T>
__host__ __device__ constexpr int chunk_elems() {
  return kChunkBytes / static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr bool is_bf16() { return std::is_same<T, bf16>::value; }

// staged positions per buffer and the number of buffers
__host__ __device__ inline int positions(const ConvArgs& a, bool rows) {
  return (a.th + 2) * (a.tw + 2) * (rows ? a.d : a.d + 2);
}

template <typename T>
__host__ __device__ inline size_t buffer_bytes(const ConvArgs& a, bool rows) {
  const size_t row_bytes = is_bf16<T>() ? kChunkBytes : kF32Stride * sizeof(float);
  return ltu::align_up(positions(a, rows) * row_bytes, 128);
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(const ConvArgs& a, bool rows, int nt) {
  return (rows ? 3 : 1) * buffer_bytes<T>(a, rows) +
         sizeof(T) * 9 * static_cast<size_t>(chunk_elems<T>()) * nt;
}

template <typename T, int NT, bool kRows>
__global__ void __launch_bounds__(kThreads) conv_cl_kernel(const ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KC = chunk_elems<T>();
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte piece
  const int P = positions(a, kRows);
  const size_t buf_bytes = buffer_bytes<T>(a, kRows);
  T* s_w = reinterpret_cast<T*>(smem + (kRows ? 3 : 1) * buf_bytes);

  const int tiles_w = a.w / a.tw;
  const int h0 = (blockIdx.x / tiles_w) * a.th;
  const int w0 = (blockIdx.x % tiles_w) * a.tw;
  const int n = blockIdx.y;
  const int o0 = blockIdx.z * NT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* x = static_cast<const T*>(a.x);
  const T* wt = static_cast<const T*>(a.k);

  // bf16: this warp's 16 positions; f32: this thread's position and channels
  constexpr bool kMma = is_bf16<T>();
  constexpr int OPT = NT / 2;
  const int m_first = kMma ? warp * 16 : tid % kM;
  const int dl = m_first % a.d;
  const int wl = (m_first / a.d) % a.tw;
  const int hl = m_first / (a.d * a.tw);
  const int og = tid / kM;
  float acc[kMma ? NT / 8 : 1][4];
  float facc[kMma ? 1 : OPT];
#pragma unroll
  for (int j = 0; j < (kMma ? NT / 8 : 1); ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < (kMma ? 1 : OPT); ++j) facc[j] = 0.f;

  for (int c0 = 0; c0 < a.c; c0 += KC) {
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < (kRows ? 3 : 1) * P * kPieces; i += kThreads) {
      const int piece = i % kPieces;
      const int pos = (i / kPieces) % P;
      const int b = i / (kPieces * P);
      const int dd = pos % (kRows ? a.d : a.d + 2);
      const int r = pos / (kRows ? a.d : a.d + 2);
      const int gw = w0 + r % (a.tw + 2) - 1;
      const int gh = h0 + r / (a.tw + 2) - 1;
      const int gd = kRows ? dd + b - 1 : dd - 1;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gh >= 0 && gh < a.h && gw >= 0 && gw < a.w && gd >= 0 && gd < a.d) {
        v = *reinterpret_cast<const uint4*>(
            x + (((static_cast<long long>(n) * a.h + gh) * a.w + gw) * a.d + gd) * a.c + c0 +
            piece * kVec);
      }
      unsigned char* buf = smem + b * buf_bytes;
      if constexpr (kMma) {
        *reinterpret_cast<uint4*>(reinterpret_cast<bf16*>(buf) + ltu::swz(pos, piece, kPieces)) = v;
      } else {
        float* dst = reinterpret_cast<float*>(buf) + pos * kF32Stride + piece * 4;
        dst[0] = __uint_as_float(v.x);
        dst[1] = __uint_as_float(v.y);
        dst[2] = __uint_as_float(v.z);
        dst[3] = __uint_as_float(v.w);
      }
    }
    for (int kh = 0; kh < 3; ++kh) {
      if (kh) __syncthreads();  // the previous dh's weights are read
      // weights of the 9 taps of this dh, channels [c0, c0 + KC), outputs [o0, o0 + NT)
      for (int i = tid; i < 9 * KC * (NT / kVec); i += kThreads) {
        const int piece = i % (NT / kVec);
        const int k = (i / (NT / kVec)) % KC;
        const int j = i / ((NT / kVec) * KC);
        const uint4 v = *reinterpret_cast<const uint4*>(
            wt + (static_cast<long long>(kh * 9 + j) * a.c + c0 + k) * a.o + o0 + piece * kVec);
        if constexpr (kMma) {
          *reinterpret_cast<uint4*>(s_w + j * KC * NT + ltu::swz(k, piece, NT / 8)) = v;
        } else {
          *reinterpret_cast<uint4*>(s_w + (j * KC + k) * NT + piece * kVec) = v;
        }
      }
      __syncthreads();
      for (int j = 0; j < 9; ++j) {
        const int kw = j / 3, kd = j % 3;
        const int cell = (hl + kh) * (a.tw + 2) + wl + kw;
        const int row = kRows ? cell * a.d + dl : cell * (a.d + 2) + dl + kd;
        const unsigned char* buf = smem + (kRows ? kd : 0) * buf_bytes;
        if constexpr (kMma) {
          ltu::warp_mma<KC, NT>(acc, reinterpret_cast<const bf16*>(buf), row,
                                reinterpret_cast<const bf16*>(s_w) + j * KC * NT, 0, NT / 16,
                                lane);
        } else {
          const float* ar = reinterpret_cast<const float*>(buf) + row * kF32Stride;
          const float* wr = reinterpret_cast<const float*>(s_w) + j * KC * NT + og * OPT;
#pragma unroll 4
          for (int k = 0; k < KC; ++k) {
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
  }

  T* out = static_cast<T*>(a.out);
  const long long cell = (static_cast<long long>(n) * a.h + h0 + hl) * a.w + w0 + wl;
  if constexpr (kMma) {
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int o = o0 + j * 8 + 2 * (lane & 3);
      const float b0 = a.bias ? a.bias[o] : 0.f;
      const float b1 = a.bias ? a.bias[o + 1] : 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int d = dl + (lane >> 2) + hh * 8;
        *reinterpret_cast<__nv_bfloat162*>(out + (cell * a.d + d) * a.o + o) =
            __floats2bfloat162_rn(acc[j][2 * hh] + b0, acc[j][2 * hh + 1] + b1);
      }
    }
  } else {
    T* dst = out + (cell * a.d + dl) * a.o + o0 + og * OPT;
#pragma unroll
    for (int q = 0; q < OPT; ++q) {
      dst[q] = facc[q] + (a.bias ? a.bias[o0 + og * OPT + q] : 0.f);
    }
  }
}

template <typename T, int NT, bool kRows>
int launch(const ConvArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a, kRows, NT);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv_cl_kernel<T, NT, kRows>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.h / a.th) * (a.w / a.tw), a.n, a.o / NT);
  conv_cl_kernel<T, NT, kRows><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRows>
int dispatch(const ConvArgs& a, cudaStream_t s) {
  return a.o % 128 == 0 ? launch<T, 128, kRows>(a, s) : launch<T, 64, kRows>(a, s);
}

}  // namespace

extern "C" {

// Shared memory of one block; the wrapper checks it against the limit.
int pc_smem_bytes(int d, int th, int tw, int o, int rows, int is_bf16) {
  ConvArgs a{};
  a.d = d;
  a.th = th;
  a.tw = tw;
  const int nt = o % 128 == 0 ? 128 : 64;
  return static_cast<int>(is_bf16 ? smem_bytes<bf16>(a, rows != 0, nt)
                                  : smem_bytes<float>(a, rows != 0, nt));
}

// x (n, h, w, d, c) and out (n, h, w, d, o) channels-last, k (3, 3, 3, c, o),
// all contiguous and of one dtype (bf16 if is_bf16, else f32); bias (o,)
// f32 or null. th * tw * d == 128, th | h, tw | w, d % 16 == 0, c % 32 == 0
// (bf16) or c % 16 == 0 (f32), o % 64 == 0. rows: 0 for the halo design,
// 1 for the depth-shifted copies. Returns the CUDA error (0 on success).
int pc_forward(const void* x, const void* k, const void* bias, void* out, int n, int h, int w,
               int d, int c, int o, int th, int tw, int rows, int is_bf16, void* stream) {
  if (th * tw * d != kM || h % th || w % tw || d % 16 || o % 64 ||
      c % (is_bf16 ? 32 : 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ConvArgs a{x, k, static_cast<const float*>(bias), out, n, h, w, d, c, o, th, tw};
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return rows ? dispatch<bf16, true>(a, s) : dispatch<bf16, false>(a, s);
  return rows ? dispatch<float, true>(a, s) : dispatch<float, false>(a, s);
}

}  // extern "C"
