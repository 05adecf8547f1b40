// Depthwise 3x3x3 convolution (stride 1, padding 1) of channels-last bf16
// tensors for Hopper (sm_90a), bound with ctypes.
//
// For x held in memory as (N, S1, S2, S3, C) bf16 (the channels-last
// (N, C, S1, S2, S3) view that the model's positional encodings,
// `blocks.ConvPosEmbed3d`, convolve), a weight (C, 1, 3, 3, 3) in f32 or
// bf16 and an optional bf16 bias (C,):
//
//   y[n, i1, i2, i3, c] = bias[c] + sum over a, b, e of
//       w[c, 0, a, b, e] * x[n, i1 + a - 1, i2 + b - 1, i3 + e - 1, c]
//
// with x read as 0 outside the volume: `F.conv3d(x, w, bias, 1, 1, 1, C)`
// with the weight rounded to bf16, the 27 products summed in f32, the bias
// added in f32 and y rounded to bf16 once, written in x's layout.
//
// It replaces no TPU kernel: the JAX package left its convolutions to XLA.
// It was added because cuDNN runs these convolutions on a channels-last
// input with its generic engine, `implicit_convolveNd_sgemm`, launched once
// per channel with a layout transpose each time: 13.1 ms of a training
// micro-step and 3.0 ms of a served window on the H100 (PERF.md, section 6).
//
// What bounds it on this card: bytes, barely. A depthwise product has no
// shared dimension to put on the tensor cores: 27 multiply-adds an output
// against 4 bytes read and written, ~13.5 FLOP a byte, under the H100's ~295
// but not far under the 20 of its f32 CUDA cores. (4, 256, 8, 16, 16) reads
// and writes 8.4 MB: 2.5 us at 3.35 TB/s; its 57 M multiply-adds take 1.9 us
// of every f32 lane.
//
// Design: CUDA cores, f32 sums, no atomics, one launch a call.
// * A block owns a tile of 4 x 8 x 4 output voxels (S1, S2, S3) of one
//   64-channel slab. It stages the tile with its one-voxel halo, 6 x 10 x 6
//   voxels of the slab (46 KB), in shared memory by 16-byte `cp.async`
//   copies, zero filled outside the volume (the padding) and past the
//   channels; each input element then comes from device memory or L2 once
//   a tile, not 27 times. The slab's weights and bias come by `cp.async`
//   beside it, so no load waits on another; the weights are then rounded
//   to bf16 and laid out, in f32, for the products' reads.
// * A thread owns 8 channels (one 16-byte vector) of the tile's 4 outputs
//   along S1 at one (i2, i3). For each of the 9 (b, e) tap columns it holds
//   the column's 3 weight vectors in registers and reads the 6 input vectors
//   of its halo column once, adding each into the up to 3 outputs it
//   reaches. A quarter warp reads one voxel's 64 channels, 128 contiguous
//   bytes, so the reads are free of bank conflicts; every load and store of
//   device memory is a 16-byte vector of whole channel rows.
// * Each output has one owner and its taps are summed in a fixed order, so
//   a call gives the same bits on every run. Ragged tiles (the ROI crops:
//   39 x 23, 24 x 14, 15 x 9) are masked at the stores.
// What still separates it from the bound (PERF.md, section 6, row 14): a
// call is about one round of blocks, and a block's phases (staging, the
// products, the stores) run in turn, so little overlaps.
// The kernel's name starts with `conv_unit_depthwise`, the port's prefix
// for its convolution kernels, which keeps it apart from cuDNN's in a trace.

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;                    // channels a thread: one 16-byte vector
constexpr int kSlab = 64;                  // channels a block
constexpr int kVecs = kSlab / kVec;        // vectors a voxel of the slab
constexpr int kT1 = 4, kT2 = 8, kT3 = 4;   // output voxels a tile; S1 is a thread's run
constexpr int kH1 = kT1 + 2, kH2 = kT2 + 2, kH3 = kT3 + 2;  // the tile with its halo
constexpr int kHalo = kH1 * kH2 * kH3;
constexpr int kColumns = kT2 * kT3;
constexpr int kThreads = kVecs * kColumns;
constexpr int kTaps = 27;
constexpr int kXBytes = kHalo * kSlab * 2;
constexpr int kWBytes = kTaps * kSlab * 4;
constexpr int kSmem = kXBytes + 2 * kWBytes + kSlab * 2;
constexpr int kXCopies = kHalo * kVecs;
// three blocks an SM: the calls of 300-1,000 tiles then take one or two
// rounds; the cap (80 registers) spills 36 bytes a thread
constexpr int kBlocksPerSM = 3;

struct Args {
  const bf16* x;     // (n, s1, s2, s3, c)
  const void* w;     // (c, 27), f32 or bf16
  const bf16* bias;  // (c,) or null
  bf16* y;           // (n, s1, s2, s3, c)
  int n, s1, s2, s3, c;
  int w_bf16;
  int tiles1, tiles2, tiles3, slabs;
};

// The 8 bf16 of a 16-byte vector as f32, in order.
__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[kVec]) {
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[2 * k] = __uint_as_float(words[k] << 16);
    out[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM) conv_unit_depthwise(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem);
  // sw[((tap * 2 + half) * kVecs + v) * 4 + k]: channel 8 v + 4 half + k,
  // so that a quarter warp's 16-byte reads of one tap are 128 contiguous bytes
  float* sw = reinterpret_cast<float*>(smem + kXBytes);
  char* wraw = reinterpret_cast<char*>(smem + kXBytes + kWBytes);  // as they lie in w
  bf16* sbias = reinterpret_cast<bf16*>(smem + kXBytes + 2 * kWBytes);
  const int tid = threadIdx.x;

  int b = blockIdx.x;
  const int slab = b % a.slabs;
  b /= a.slabs;
  const int t3 = b % a.tiles3;
  b /= a.tiles3;
  const int t2 = b % a.tiles2;
  b /= a.tiles2;
  const int t1 = b % a.tiles1;
  const int n = b / a.tiles1;
  const int o1 = t1 * kT1, o2 = t2 * kT2, o3 = t3 * kT3, c0 = slab * kSlab;
  const int channels = min(kSlab, a.c - c0);

  // the halo tile: voxel q = (h1 * kH2 + h2) * kH3 + h3 holds the slab's
  // 64 channels, 128 bytes
  const long long row = a.c;
  const bf16* xn = a.x + static_cast<long long>(n) * a.s1 * a.s2 * a.s3 * row + c0;
#pragma unroll
  for (int k = 0; k < (kXCopies + kThreads - 1) / kThreads; ++k) {
    const int i = tid + k * kThreads;
    if (i >= kXCopies) break;
    const int v = i % kVecs, q = i / kVecs;
    const int j1 = o1 - 1 + q / (kH2 * kH3), j2 = o2 - 1 + (q / kH3) % kH2,
              j3 = o3 - 1 + q % kH3;
    const bool valid = static_cast<unsigned>(j1) < static_cast<unsigned>(a.s1) &&
                       static_cast<unsigned>(j2) < static_cast<unsigned>(a.s2) &&
                       static_cast<unsigned>(j3) < static_cast<unsigned>(a.s3) &&
                       v * kVec < channels;
    const bf16* src =
        valid ? xn + ((static_cast<long long>(j1) * a.s2 + j2) * a.s3 + j3) * row + v * kVec
              : a.x;
    ltu::cp_async16_zfill(sx + q * kSlab + v * kVec, src, valid);
  }
  // the slab's weights, w[c0 * 27 ...] on as they lie, and its bias (zero
  // where there is none)
  const int wsize = a.w_bf16 ? 2 : 4;
  const char* wsrc = static_cast<const char*>(a.w) + static_cast<long long>(c0) * kTaps * wsize;
  for (int i = tid * 16; i < channels * kTaps * wsize; i += kThreads * 16) {
    ltu::cp_async16(wraw + i, wsrc + i);
  }
  if (tid < kVecs) {
    const bool valid = a.bias != nullptr && tid * kVec < channels;
    ltu::cp_async16_zfill(sbias + tid * kVec, valid ? a.bias + c0 + tid * kVec : a.x, valid);
  }
  ltu::cp_async_commit();
  ltu::cp_async_wait_all();
  __syncthreads();

  // each weight rounded to bf16 and laid out for the products' reads
  for (int i = tid; i < kTaps * kSlab; i += kThreads) {
    const int cl = i / kTaps, tap = i % kTaps;
    float value = 0.f;
    if (cl < channels) {
      value = a.w_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(wraw)[i])
                       : ltu::round_to<bf16>(reinterpret_cast<const float*>(wraw)[i]);
    }
    sw[((tap * 2 + (cl % kVec) / 4) * kVecs + cl / kVec) * 4 + cl % 4] = value;
  }
  __syncthreads();

  const int v = tid % kVecs, col = tid / kVecs;
  const int c3 = col % kT3, c2 = col / kT3;
  float acc[kT1][kVec];
#pragma unroll
  for (int r = 0; r < kT1; ++r) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[r][k] = 0.f;
  }
  // the tap columns (b, e) in turn: the column's 3 weight vectors in
  // registers, then its 6 inputs along S1, each added into the up to 3
  // outputs it reaches (output r takes input p at tap a = p - r)
#pragma unroll 1
  for (int tb = 0; tb < 3; ++tb) {
#pragma unroll
    for (int te = 0; te < 3; ++te) {
      float w8[3][kVec];
#pragma unroll
      for (int ta = 0; ta < 3; ++ta) {
        const int tap = (ta * 3 + tb) * 3 + te;
        const float4 lo = *reinterpret_cast<const float4*>(sw + (tap * 2 * kVecs + v) * 4);
        const float4 hi = *reinterpret_cast<const float4*>(sw + ((tap * 2 + 1) * kVecs + v) * 4);
        w8[ta][0] = lo.x; w8[ta][1] = lo.y; w8[ta][2] = lo.z; w8[ta][3] = lo.w;
        w8[ta][4] = hi.x; w8[ta][5] = hi.y; w8[ta][6] = hi.z; w8[ta][7] = hi.w;
      }
      const bf16* column = sx + ((c2 + tb) * kH3 + c3 + te) * kSlab + v * kVec;
#pragma unroll
      for (int p = 0; p < kH1; ++p) {
        float in[kVec];
        unpack(*reinterpret_cast<const uint4*>(column + p * kH2 * kH3 * kSlab), in);
#pragma unroll
        for (int ta = 0; ta < 3; ++ta) {
          const int r = p - ta;
          if (r < 0 || r >= kT1) continue;
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[r][k] = fmaf(w8[ta][k], in[k], acc[r][k]);
        }
      }
    }
  }

  const int i2 = o2 + c2, i3 = o3 + c3;
  if (v * kVec >= channels || i2 >= a.s2 || i3 >= a.s3) return;
  float bias[kVec];
  unpack(*reinterpret_cast<const uint4*>(sbias + v * kVec), bias);
#pragma unroll
  for (int r = 0; r < kT1; ++r) {
    const int i1 = o1 + r;
    if (i1 >= a.s1) break;
    unsigned words[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(acc[r][2 * k] + bias[2 * k], acc[r][2 * k + 1] + bias[2 * k + 1]);
      words[k] = *reinterpret_cast<const unsigned*>(&pair);
    }
    const long long at =
        (((static_cast<long long>(n) * a.s1 + i1) * a.s2 + i2) * a.s3 + i3) * row + c0 + v * kVec;
    *reinterpret_cast<uint4*>(a.y + at) = make_uint4(words[0], words[1], words[2], words[3]);
  }
}

}  // namespace

extern "C" {

// x, y: bf16 (n, s1, s2, s3, c) in memory, 16-byte aligned; weight: (c, 1,
// 3, 3, 3) contiguous, bf16 (weight_bf16 != 0) or f32, 16-byte aligned;
// bias: bf16 (c,), 16-byte aligned, or null. dims: n, c, s1, s2, s3; c a
// multiple of 8. One launch on `stream`; returns the CUDA error of the
// launch (0 on success).
int cd_forward(const void* x, const void* weight, int weight_bf16, const void* bias, void* y,
               const long long* dims, void* stream) {
  Args a{};
  a.n = static_cast<int>(dims[0]);
  a.c = static_cast<int>(dims[1]);
  a.s1 = static_cast<int>(dims[2]);
  a.s2 = static_cast<int>(dims[3]);
  a.s3 = static_cast<int>(dims[4]);
  if (a.n < 1 || a.c < kVec || a.c % kVec != 0 || a.s1 < 1 || a.s2 < 1 || a.s3 < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.tiles1 = (a.s1 + kT1 - 1) / kT1;
  a.tiles2 = (a.s2 + kT2 - 1) / kT2;
  a.tiles3 = (a.s3 + kT3 - 1) / kT3;
  a.slabs = (a.c + kSlab - 1) / kSlab;
  const long long blocks =
      static_cast<long long>(a.n) * a.tiles1 * a.tiles2 * a.tiles3 * a.slabs;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // the attribute once: a captured call (CUDA graphs) then only launches
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_unit_depthwise, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready = true;
  }
  a.x = static_cast<const bf16*>(x);
  a.w = weight;
  a.w_bf16 = weight_bf16;
  a.bias = static_cast<const bf16*>(bias);
  a.y = static_cast<bf16*>(y);
  conv_unit_depthwise<<<static_cast<unsigned>(blocks), kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
