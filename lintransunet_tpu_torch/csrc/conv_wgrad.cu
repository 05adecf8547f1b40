// Weight gradient of a depthwise 3x3x3 convolution (stride 1, padding 1)
// for Hopper (sm_90a), bound with ctypes.
//
// For x and dy of shape (N, C, S1, S2, S3) in bf16, with any strides:
//
//   dw[c, 0, a, b, e] = sum over (n, i1, i2, i3) of
//                       dy[n, c, i1, i2, i3] * x[n, c, i1 + a - 1, i2 + b - 1, i3 + e - 1]
//
// (x read as 0 outside the volume), in f32: the gradient of the f32 weight
// of `ops.conv3d`'s depthwise convolutions.
//
// It replaces no TPU kernel: the JAX package left its convolutions to XLA.
// It was added because cuDNN sends the weight gradient of the flagship's
// 256-channel positional-encoding convolutions (`blocks.ConvPosEmbed3d`,
// run on a channels-last view of the tokens) to its generic engine,
// `cudnn::cnn::convolveNd_wgrad_engine`, which took 42-102 ms a call, 221 ms
// of a 331 ms training micro-step on the H100 (PERF.md, section 6).
//
// What bounds it on this card: bytes. A depthwise weight gradient has no
// shared dimension to put on the tensor cores: it is 27 dot products a
// channel over the N * S1 * S2 * S3 voxels, 54 FLOP a voxel and channel
// against 4 bytes read (x and dy once each), so the largest routed call
// (3 x 256 x 8 x 24 x 14) is ~8.3 MB and ~0.11 GFLOP, 2.5 us at 3.35 TB/s.
//
// Design: CUDA cores, f32 accumulation, no atomics.
// * `conv_unit_wgrad_dw`: a block is 32 channels x 8 voxel lanes and owns
//   a contiguous chunk of the voxels (the split over the voxel axis,
//   blockIdx.y). Neighbouring lanes of a warp take neighbouring channels,
//   so on the model's channels-last views each of the 27 reads of a voxel
//   is one coalesced 64-byte row, and the 27 sums stay in registers. The
//   block adds its 8 lanes through shared memory in a fixed order and
//   writes one partial per (chunk, channel, tap).
// * `conv_unit_wgrad_sum`: adds the chunks' partials in chunk order. The
//   result is the same bits on every run, where cuDNN's weight gradient is
//   not deterministic.
// The kernels' names start with `conv_unit` (the port's prefix for its
// convolution kernels), which keeps them apart from cuDNN's in a trace.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChannels = 32;  // channels a block, one a lane of each warp
constexpr int kLanes = 8;      // voxel lanes a block, one a warp
constexpr int kTaps = 27;

struct Dims {
  long long n, c, s1, s2, s3;
  long long xs[5], ys[5];  // strides of x and dy, in elements
};

__global__ void __launch_bounds__(kChannels * kLanes)
conv_unit_wgrad_dw(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                   float* __restrict__ partial, Dims d, long long chunk) {
  __shared__ float red[kLanes][kTaps][kChannels];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * kChannels + tx;
  const long long voxels = d.n * d.s1 * d.s2 * d.s3;
  const long long begin = blockIdx.y * chunk;
  const long long end = min(voxels, begin + chunk);

  float acc[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) acc[t] = 0.f;

  if (c < d.c) {
    const bf16* xc = x + c * d.xs[1];
    const bf16* yc = dy + c * d.ys[1];
    for (long long v = begin + ty; v < end; v += kLanes) {
      long long r = v;
      const long long i3 = r % d.s3; r /= d.s3;
      const long long i2 = r % d.s2; r /= d.s2;
      const long long i1 = r % d.s1;
      const long long n = r / d.s1;
      const float g = __bfloat162float(
          yc[n * d.ys[0] + i1 * d.ys[2] + i2 * d.ys[3] + i3 * d.ys[4]]);
      const bf16* xn = xc + n * d.xs[0];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const long long j1 = i1 + a - 1;
        if (j1 < 0 || j1 >= d.s1) continue;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const long long j2 = i2 + b - 1;
          if (j2 < 0 || j2 >= d.s2) continue;
          const bf16* row = xn + j1 * d.xs[2] + j2 * d.xs[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const long long j3 = i3 + e - 1;
            if (j3 < 0 || j3 >= d.s3) continue;
            acc[a * 9 + b * 3 + e] += g * __bfloat162float(row[j3 * d.xs[4]]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTaps; ++t) red[ty][t][tx] = acc[t];
  __syncthreads();
  if (c >= d.c) return;
  for (int t = ty; t < kTaps; t += kLanes) {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s += red[l][t][tx];
    partial[(blockIdx.y * d.c + c) * kTaps + t] = s;
  }
}

__global__ void conv_unit_wgrad_sum(const float* __restrict__ partial, float* __restrict__ dw,
                                    long long weights, int chunks) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < weights;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k) s += partial[k * weights + i];
    dw[i] = s;
  }
}

}  // namespace

extern "C" {

// x, dy: bf16 (n, c, s1, s2, s3) with the strides in `dims`; partial: f32
// scratch (chunks, c, 27); dw: f32 (c, 27), contiguous. dims: n, c, s1,
// s2, s3, x's five strides, dy's five strides (elements). The voxels are
// split into `chunks` contiguous chunks. Launches on `stream`; returns the
// CUDA error of the launches (0 on success).
int cw_depthwise(const void* x, const void* dy, void* partial, void* dw,
                 const long long* dims, int chunks, void* stream) {
  Dims d;
  d.n = dims[0]; d.c = dims[1]; d.s1 = dims[2]; d.s2 = dims[3]; d.s3 = dims[4];
  for (int i = 0; i < 5; ++i) {
    d.xs[i] = dims[5 + i];
    d.ys[i] = dims[10 + i];
  }
  const long long voxels = d.n * d.s1 * d.s2 * d.s3;
  const long long chunk = (voxels + chunks - 1) / chunks;
  auto s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((d.c + kChannels - 1) / kChannels), (unsigned)chunks);
  conv_unit_wgrad_dw<<<grid, dim3(kChannels, kLanes), 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy), static_cast<float*>(partial), d,
      chunk);
  const long long weights = d.c * kTaps;
  conv_unit_wgrad_sum<<<(unsigned)((weights + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), weights, chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
