// Warp-level bf16 tensor-core helpers shared by the probe kernels
// (csrc/probe_taps.cu, csrc/probe_conv.cu), the transformer stack
// (csrc/fused_stack.cu) and linear attention (csrc/linear_attention.cu):
// `ldmatrix` loads from XOR-swizzled shared-memory
// tiles, `mma.sync` m16n8k16 with f32 accumulation, asynchronous copies
// from device to shared memory (16-byte `cp.async`; bulk copies that
// complete on an mbarrier), and the warpgroup MMA (`wgmma`, sm_90a) with A
// from registers and B from shared memory, 16, 32, 64 or 128 columns wide.
//
// Tiles are stored as rows of 16-byte chunks (8 bf16). `swz` places chunk c
// of row r so that any 8 consecutive rows read at one logical chunk land on
// 8 different 16-byte bank groups: an `ldmatrix` phase (8 row addresses) is
// then free of bank conflicts whatever row it starts at, so an operand read
// at a shifted row offset costs no more than an aligned one. For rows of 32,
// 64 or 128 bytes it is the tensor cores' own 32-, 64- or 128-byte swizzle
// (16-byte chunk index XOR address bits 7 and up), so a `wgmma` descriptor
// reads such a tile where it starts on a 1,024-byte boundary.

#pragma once

#include <cuda_bf16.h>

namespace ltu {

// Element offset of chunk c of row r in a bf16 tile of `cpr` 16-byte chunks
// per row (cpr a power of two, 2 to 64).
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

// 16 bytes from device memory to shared memory, asynchronously (L2 only:
// the source is read once per block); completes with the commit group.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

// The same, but writes 16 zero bytes and reads nothing unless `valid`
// (`gmem` must still be a valid address).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `N` of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until all of this thread's cp.async copies, committed or not, land.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// mbarrier and bulk-copy (TMA, one-dimensional) helpers: one thread arms a
// barrier with the bytes it expects and starts the copies, which complete
// on that barrier; every thread waits on the barrier's phase parity.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the copy engine.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory to shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later copies
// by the copy engine into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Two floats rounded to bf16 and packed as one 32-bit word (lower address
// first).
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
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

// ---------------------------------------------------------------------------
// Warpgroup MMA (`wgmma`): the four warps of a warpgroup (warps 4g .. 4g + 3)
// issue one 64-row product together, asynchronously. Order: write the A
// registers (and zero the accumulators), `wgmma_fence`, the `wgmma`s,
// `wgmma_commit`, then `wgmma_wait<N>` before the accumulators or the A
// registers are touched again or B's shared memory is rewritten.
// ---------------------------------------------------------------------------

// Descriptor of a K-major B tile in shared memory: row n holds output n's K
// values, `row_bytes` (64 or 128) of them, swizzled as `swz` does; 8-row
// groups 8 * row_bytes apart; the tile starts on a 1,024-byte boundary.
// K step k16 of a row starts 32 bytes further: add (32 * step) >> 4 to the
// descriptor (start address, bits 0-13, in 16-byte units).
__device__ __forceinline__ unsigned long long wgmma_desc_kmajor(const void* tile,
                                                                int row_bytes) {
  unsigned long long desc = (smem_addr(tile) & 0x3FFFF) >> 4;                 // start address
  desc |= 1ull << 16;                                     // leading byte offset: unused (1)
  desc |= static_cast<unsigned long long>(8 * row_bytes >> 4) << 32;  // stride byte offset
  desc |= static_cast<unsigned long long>(row_bytes == 128 ? 1 : 2) << 62;  // 128 / 64 B
  return desc;
}

// Orders this warpgroup's register writes before the `wgmma`s that read them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of `d` across a commit or wait.
template <int R>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) += a (64 x 16, bf16) * B (16 x 64, bf16, by `desc_b`,
// K-major; with scale_d 0, d = a * B). Each warp of the warpgroup gives its
// 16 rows of A as the A fragment of `mma.sync` m16n8k16 (`ldsm_x4` of a
// row-major tile) and gets its 16 rows of d as that instruction's
// accumulators: columns 8t .. 8t + 7 in d[4t .. 4t + 3].
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const unsigned (&a)[4],
                                                unsigned long long desc_b, int scale_d = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 16, f32) += a (64 x 16, bf16) * B (16 x 16, bf16, by `desc_b`,
// K-major), as `wgmma_m64n64k16` with 16 columns: d[4t .. 4t + 3] hold
// columns 8t .. 8t + 7.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], const unsigned (&a)[4],
                                               unsigned long long desc_b, int scale_d = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 32, f32) += a (64 x 16, bf16) * B (16 x 32, bf16, by `desc_b`,
// K-major), as `wgmma_m64n64k16` with 32 columns: d[4t .. 4t + 3] hold
// columns 8t .. 8t + 7.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const unsigned (&a)[4],
                                               unsigned long long desc_b, int scale_d = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128, f32) += a (64 x 16, bf16) * B (16 x 128, bf16, by `desc_b`,
// K-major), as `wgmma_m64n64k16` with 128 columns: d[4t .. 4t + 3] hold
// columns 8t .. 8t + 7.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const unsigned (&a)[4],
                                               unsigned long long desc_b, int scale_d = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The `wgmma` of width N (16, 32, 64 or 128 columns; N / 2 accumulators).
// scale_d 0 writes d = a * B, ignoring d: a fresh sum with no instruction
// but the `wgmma` writing the accumulators (a zeroing store between
// `wgmma`s makes ptxas serialise them).
template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], const unsigned (&a)[4],
                                             unsigned long long desc_b, int scale_d = 1) {
  if constexpr (N == 16) {
    wgmma_m64n16k16(d, a, desc_b, scale_d);
  } else if constexpr (N == 32) {
    wgmma_m64n32k16(d, a, desc_b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16(d, a, desc_b, scale_d);
  } else {
    static_assert(N == 128, "wgmma widths 16, 32, 64, 128");
    wgmma_m64n128k16(d, a, desc_b, scale_d);
  }
}

}  // namespace ltu
