// Per-lane partial sums for InstanceNorm statistics on Hopper (sm_90a),
// bound with ctypes.
//
// x (ND, H, W, L) bf16 -> out (ND, H / hblk, 2, L) f32:
//   out[i, j, 0, l] = sum over h in block j, all w, of x[i, h, w, l] * scale
//   out[i, j, 1, l] = the same sum of squares
//
// Replaces `_pallas_lane_sums` of experiments/in_stats_probe.py (pallas_call
// at :90), which fed the InstanceNorm statistics of the channels-last
// activations.
//
// What bounds it on this card: bytes. Each bf16 element costs 3 FLOP, far
// below the ~295 FLOP/byte ridge, so the least time is one read of x at
// HBM rate. Design: one block of 256 threads per (i, j) output row; each
// thread owns 8 lanes (one 16-byte load) and a stride of rows, with four
// loads in flight, and sums in f32 registers; the block then adds its row
// groups in shared memory in a fixed order, so the result is the same from
// run to run. No atomics, no second pass.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lane_sums_kernel(const bf16* __restrict__ x, float* __restrict__ out, int h, int w, int lanes,
                 int hblk, float scale) {
  extern __shared__ float red[];  // (groups, 2, lanes)
  const int vecs = lanes / 8;                 // threads per row
  const int groups = kThreads / vecs;         // rows in flight
  const int v = threadIdx.x % vecs;
  const int g = threadIdx.x / vecs;
  const int blocks_h = h / hblk;
  const int i = blockIdx.x / blocks_h, j = blockIdx.x % blocks_h;
  const int rows = hblk * w;
  const bf16* base = x + (static_cast<long long>(i) * h + static_cast<long long>(j) * hblk) *
                             w * lanes + v * 8;
  float s[8], q[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s[e] = q[e] = 0.f;
#pragma unroll 4
  for (int r = g; r < rows; r += groups) {
    const uint4 raw =
        __ldg(reinterpret_cast<const uint4*>(base + static_cast<long long>(r) * lanes));
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(pairs[e]);
      const float a = f.x * scale, b = f.y * scale;
      s[2 * e] += a;
      q[2 * e] += a * a;
      s[2 * e + 1] += b;
      q[2 * e + 1] += b * b;
    }
  }
  if (threadIdx.x < groups * vecs) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[(g * 2 + 0) * lanes + v * 8 + e] = s[e];
      red[(g * 2 + 1) * lanes + v * 8 + e] = q[e];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * lanes; idx += kThreads) {
    float acc = 0.f;
    for (int gg = 0; gg < groups; ++gg) acc += red[gg * 2 * lanes + idx];
    out[static_cast<long long>(blockIdx.x) * 2 * lanes + idx] = acc;
  }
}

}  // namespace

extern "C" {

// x (nd, h, w, lanes) bf16 contiguous; out (nd, h / hblk, 2, lanes) f32.
// lanes a multiple of 8 dividing 2048 (8 lanes a thread); h % hblk == 0.
// Returns the CUDA error of the launch (0 on success).
int ps_lane_sums(const void* x, void* out, int nd, int h, int w, int lanes, int hblk,
                 float scale, void* stream) {
  if (lanes % 8 || 2048 % lanes || hblk < 1 || h % hblk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = kThreads / (lanes / 8);
  const size_t smem = sizeof(float) * groups * 2 * lanes;
  lane_sums_kernel<<<nd * (h / hblk), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<float*>(out), h, w, lanes, hblk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
