// Device helpers shared by the segment-flash kernels H1 (flash_fwd.cu)
// and H2 (flash_bwd.cu): 16- and 4-byte cp.async copies, ldmatrix,
// bf16 mma.sync m16n8k16 with an fp32 accumulator, and the row loader
// that reads one head's D columns of a (T, H*D) tensor into a shared
// memory tile.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 * g + tq.
// The accumulator of a 16 x 8 tile holds rows g (c[0], c[1]) and g + 8
// (c[2], c[3]) at columns 2 tq, 2 tq + 1. Two neighbouring accumulator
// tiles of a 16 x 16 block, packed to bf16 pairs, are the A operand of
// the next product (see pack_bf16), so scores never leave registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace esme {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; reads nothing and zero-fills when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of the 16-wide k-step kk from accumulator tiles 2 kk and
// 2 kk + 1 (rows of the accumulator become rows of A, its columns the
// contraction), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// ldmatrix addresses into a row-major bf16 tile with row stride LD:
// - a_addr: the A operand (16 rows from row0, 16 columns from col0);
// - b_addr: the B operand of two 8-wide n-tiles whose n index runs
//   along the tile's rows (16 rows from row0) and whose contraction runs
//   along its columns (16 from col0), e.g. K in Q K^T;
// - with ldmatrix .trans, a_addr also gives the B operand of two 8-wide
//   n-tiles whose n index runs along the tile's columns (16 from col0)
//   and whose contraction runs along its rows (16 from row0), e.g. V in
//   P V.
template <int LD>
__device__ __forceinline__ uint32_t a_addr(const bf16* tile, int row0,
                                           int col0, int lane) {
  return smem_u32(tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                  col0 + (lane >> 4) * 8);
}

template <int LD>
__device__ __forceinline__ uint32_t b_addr(const bf16* tile, int row0,
                                           int col0, int lane) {
  return smem_u32(tile + (row0 + (lane & 7) + (lane >> 4) * 8) * LD + col0 +
                  ((lane >> 3) & 1) * 8);
}

// Start the copies of rows [row0, row0 + ROWS) of one head's D columns
// of a (T, HD) tensor into a tile with row stride LD, by NTHREADS
// threads; columns >= D and rows >= T are zero-filled. D is a multiple
// of 8, so every chunk is 16 bytes.
template <int DP, int LD, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int row0, int T, int HD, int col0,
                                          int D) {
  constexpr int CPR = DP / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const int t = row0 + r;
    const bool valid = t < T && c < D;
    const bf16* g = valid ? src + (size_t)t * HD + col0 + c : src;
    cp_async16(smem_u32(dst + r * LD + c), g, valid);
  }
}

// Start the copies of n 4-byte values src[i0 + i], i < n, into dst;
// entries past T are zero-filled (callers mask them by position).
template <int NTHREADS>
__device__ __forceinline__ void load_words(void* dst, const void* src,
                                           int i0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    const int t = i0 + i;
    cp_async4(smem_u32(static_cast<uint32_t*>(dst) + i),
              static_cast<const uint32_t*>(src) + (t < T ? t : 0), t < T);
  }
}

}  // namespace esme
