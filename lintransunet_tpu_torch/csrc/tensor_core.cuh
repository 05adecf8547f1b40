// Warp-level bf16 tensor-core helpers shared by the probe kernels
// (csrc/probe_taps.cu, csrc/probe_conv.cu): `ldmatrix` loads from XOR-swizzled
// shared-memory tiles and `mma.sync` m16n8k16 with f32 accumulation.
//
// Tiles are stored as rows of 16-byte chunks (8 bf16). `swz` places chunk c
// of row r so that any 8 consecutive rows read at one logical chunk land on
// 8 different 16-byte bank groups: an `ldmatrix` phase (8 row addresses) is
// then free of bank conflicts whatever row it starts at, so an operand read
// at a shifted row offset costs no more than an aligned one.

#pragma once

#include <cuda_bf16.h>

namespace ltu {

// Element offset of chunk c of row r in a bf16 tile of `cpr` 16-byte chunks
// per row (cpr a power of two, 2 to 16).
__device__ __forceinline__ int swz(int r, int c, int cpr) {
  const int f = cpr >= 8 ? (r & 7) : ((r * cpr / 8) & (cpr - 1));
  return (r * cpr + (c ^ f)) * 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed (B operands stored k-major).
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row major) * b (16 x 8, column major), f32 accumulate.
// d[0], d[1]: row lane / 4, columns 2 (lane % 4) + {0, 1}; d[2], d[3]: row
// lane / 4 + 8, the same columns.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 16 output rows times NT columns over KC (a multiple of 16) of K:
// acc[j] holds columns 8j..8j+7. A: a swizzled tile of KC / 8 chunks per
// row, the warp's rows starting at row `a_row` (any row). B: a swizzled
// KC x NT tile (NT / 8 chunks per row). Only column pairs p (16 columns
// each) in [p_lo, p_hi) are computed.
template <int KC, int NT>
__device__ __forceinline__ void warp_mma(float (&acc)[NT / 8][4], const __nv_bfloat16* a_tile,
                                         int a_row, const __nv_bfloat16* b_tile, int p_lo,
                                         int p_hi, int lane) {
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    unsigned a[4];
    ldsm_x4(a, a_tile + swz(a_row + (lane & 15), ks * 2 + (lane >> 4), KC / 8));
#pragma unroll
    for (int p = 0; p < NT / 16; ++p) {
      if (p < p_lo || p >= p_hi) continue;
      unsigned b[4];
      ldsm_x4_t(b, b_tile + swz(ks * 16 + (lane & 15), p * 2 + (lane >> 4), NT / 8));
      mma_bf16_16816(acc[2 * p], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace ltu
