// Hopper (sm_90a) device helpers for the warp-specialised kernels: TMA
// tile loads through tensor maps, the mbarrier ring that a producer warp
// and the consumer warpgroups share, and wgmma with its
// shared-memory descriptors and register fragments. H2's and H1's Hopper
// forms (flash_bwd_sm90.cu, flash_fwd_sm90.cu) use them; the mma.sync
// kernels keep flash_common.cuh alone, so their ptxas lines cannot move.
//
// Operand tiles. A tile of ROWS rows of a (T, H*D) bf16 tensor comes in
// by TMA as NH column halves of HALF_COLS = min(D, 64) columns (NH = 2 at
// D = 128), each ROWS x RB bytes with RB = 2 * HALF_COLS, swizzled with
// the RB-byte pattern (128B at D >= 64, 64B at D = 32): the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8). wgmma reads the same tile as
// - K-major (the contraction runs along the row, e.g. K in S = Q K^T):
//   8-row groups SBO = 8 RB bytes apart, a 16-wide k-step 32 bytes
//   further along the row (or in the next half);
// - MN-major (the contraction runs down the rows, e.g. dO in dV = P^T dO;
//   the .trans B operand): a 16-row k-step 16 RB bytes further down, 8-row
//   groups SBO = 8 RB apart, N = HALF_COLS columns per instruction.
// Every tile starts on a 1024-byte boundary, so each k-step keeps the
// swizzle's phase and the descriptors' base offset is 0.
//
// Fragments (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup holds
// rows 16 w + g and 16 w + g + 8 (lane = 4 g + tq). Accumulator register
// 4 j + 2 r + e holds row 16 w + g + 8 r, column 8 j + 2 tq + e, as
// mma.sync's m16n8 tiles side by side; the A operand from registers is
// mma.sync's m16n8k16 A fragment, so the accumulator of 16 columns,
// rounded to bf16 pairs, is the A operand of the next product (acc_to_a).

#pragma once

#include <cuda.h>

#include <utility>

#include "flash_common.cuh"

namespace esme {
namespace sm90 {

// ---------------------------------------------------------------------------
// Tile geometry by head dim
// ---------------------------------------------------------------------------

template <int D>
struct Geo {
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64, 128");
  static constexpr int HALF_COLS = D < 64 ? D : 64;  // columns per TMA box
  static constexpr int RB = 2 * HALF_COLS;           // bytes per box row
  static constexpr int NH = D / HALF_COLS;           // boxes per row
  static constexpr int LAYOUT = RB == 128 ? 1 : 2;   // wgmma: B128, B64
  template <int ROWS>
  static constexpr int tile_bytes() { return ROWS * RB * NH; }
};

__host__ __device__ constexpr int align1k(int x) { return (x + 1023) & ~1023; }

// The first 1024-byte boundary of the shared window at or after p (the
// dynamic allocation asks for 1024 bytes more)
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// This thread's earlier cp.async copies arrive on the barrier when they
// land (one of the arrivals the barrier was initialised to expect).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A
// ring that never completes is a bug: trap (a launch failure the wrapper
// reports) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// 2-D tile load: box (x, y) = (column, row) of `map` into dst; completes
// its bytes on `bar`. Rows past the tensor's end arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// The NH boxes of rows [row0, row0 + ROWS) of one head's D columns
// (starting at column col0) into a tile laid out as above.
template <int D, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, uint64_t* bar,
                                         int col0, int row0) {
  using G = Geo<D>;
#pragma unroll
  for (int h = 0; h < G::NH; ++h)
    tma_load_2d(dst + h * ROWS * G::RB, map, bar, col0 + h * G::HALF_COLS,
                row0);
}

// 2-D tile store: shared `src` into box (x, y) of `map`; the box's parts
// past the tensor's end are not written. Commits one bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y)
      : "memory");
}

// Wait until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's ordinary shared-memory writes visible to TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Thread block clusters (launched by launch_clustered)
// ---------------------------------------------------------------------------

// This CTA's rank in its cluster (blockIdx.x % cluster size along x)
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster; orders the shared-memory
// writes before it (barrier initialisation included) before the cluster's
// accesses after it. A CTA must not exit while another CTA of its cluster
// may still arrive on its barriers or multicast into it: end with one.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Arrive on the barrier at `bar`'s offset in the shared memory of CTA
// `rank` of this cluster (this CTA's own at its own rank); its owner waits
// on it with mbar_wait. The default semantics, as CUTLASS's cluster
// pipelines hand a stage back to a TMA multicast: on the H100 the
// .release.cluster arrive with an .acquire.cluster wait made a ring shared
// by two CTAs 1.9x as slow.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// tma_load_2d into the same offset of the shared memory of every CTA of
// the cluster in `ctas` (bit r: rank r), each completing the box's bytes
// on the barrier at `bar`'s offset in its own shared memory: one read of
// the box from L2 for all of them.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int x,
                                                      int y, uint16_t ctas) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y),
      "h"(ctas)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// K-major operand: rows [row0, row0 + 64) of a ROWS-row tile at shared
// address `tile`, contraction columns [16 kk, 16 kk + 16)
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  return make_desc(tile + (col / G::HALF_COLS) * ROWS * G::RB + row0 * G::RB +
                       (col % G::HALF_COLS) * 2,
                   16, 8 * G::RB, G::LAYOUT);
}

// MN-major B operand: contraction rows [16 kk, 16 kk + 16) of a ROWS-row
// tile, its columns of half nh as N
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int nh) {
  using G = Geo<D>;
  return make_desc(tile + nh * ROWS * G::RB + kk * 16 * G::RB, ROWS * G::RB,
                   8 * G::RB, G::LAYOUT);
}

// Token-minor tiles (a (H*D, T) view of (H, D, T) tensors): a box is the
// D rows d of one head over 64 tokens, 128 bytes per row with the 128-byte
// swizzle at every D, BOX_T = 128 D bytes; a 128-token tile is two boxes.
template <int D>
struct TGeo {
  static_assert(D == 32 || D == 64 || D == 128, "head dims 32, 64, 128");
  static constexpr int BOX = 64;            // tokens per box
  static constexpr int BOX_BYTES = D * 128;
};

// MN-major operand whose tokens are M (or N) and d the contraction: d rows
// [16 kk, 16 kk + 16) of the boxes from `tile` on (the next 64 tokens one
// box further: LBO), 8-row groups 1024 bytes apart (SBO)
template <int D>
__device__ __forceinline__ uint64_t desc_t_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, TGeo<D>::BOX_BYTES, 1024, 1);
}

// K-major B operand whose tokens are the contraction and d is N: tokens
// [16 kk, 16 kk + 16) of a two-box tile, d rows [64 nh, 64 nh + N)
template <int D>
__device__ __forceinline__ uint64_t desc_t_k(uint32_t tile, int kk, int nh) {
  return make_desc(tile + (kk / 4) * TGeo<D>::BOX_BYTES + nh * 64 * 128 +
                       (kk % 4) * 32,
                   16, 1024, 1);
}

// Byte offset of element (row, col) of a Geo<D> tile of ROWS rows, as
// tma_tile lays it out (the swizzle XORs address bits 7.. into the 16-byte
// chunk bits 4..)
template <int D, int ROWS>
__device__ __forceinline__ int tile_offset(int row, int col) {
  using G = Geo<D>;
  const int off = (col / G::HALF_COLS) * ROWS * G::RB + row * G::RB +
                  (col % G::HALF_COLS) * 2;
  return off ^ (((off >> 7) & (G::RB / 16 - 1)) << 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the wait that makes them valid.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ESME_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ESME_F16(i) ESME_F4(i), ESME_F4(i + 4), ESME_F4(i + 8), ESME_F4(i + 12)

// d (64 x 64 fp32) = (accumulate ? d : 0) + A B, A (64 x 16) and B
// (16 x 64) bf16 from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ESME_F16(0), ESME_F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same with N = 128: d (64 x 128 fp32), B (16 x 128). TA and TB are
// the transpose immediates: 0 reads A (B) K-major, 1 MN-major.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : ESME_F16(0), ESME_F16(16), ESME_F16(32), ESME_F16(48)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x 64 fp32) += A B, A (64 x 16 bf16) from registers, B (16 x 64)
// from shared memory, MN-major (TB = 1) or K-major (TB = 0)
template <int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : ESME_F16(0), ESME_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// the same with N = 32 (head dim 32)
template <int TB = 1>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : ESME_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

#undef ESME_F16
#undef ESME_F4

// The A operand of k-step kk (accumulator columns [16 kk, 16 kk + 16)),
// rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[N],
                                         int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPoint), so the library needs no -lcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a (T, HD) bf16 tensor whose boxes are Geo<D>'s column halves
// of `rows` rows, swizzled as the wgmma descriptors expect
template <int D>
cudaError_t tile_map(CUtensorMap* map, const void* base, int T, int HD,
                     int rows) {
  using G = Geo<D>;
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)HD, (cuuint64_t)T};
  const cuuint64_t strides[1] = {(cuuint64_t)HD * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)G::HALF_COLS, (cuuint32_t)rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      G::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a token-minor (H, D, T) bf16 tensor viewed as (H*D, T): boxes
// of 64 tokens x D rows (one head), 128-byte swizzle. TMA needs the row
// stride, 2 T bytes, to be a multiple of 16: T % 8 == 0.
template <int D>
cudaError_t token_map(CUtensorMap* map, const void* base, int T, int HD) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (T % 8 != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)T, (cuuint64_t)HD};
  const cuuint64_t strides[1] = {(cuuint64_t)T * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)TGeo<D>::BOX, (cuuint32_t)D};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Launch `kernel` in clusters of `cluster` CTAs along x (grid.x a
// multiple of it). Returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid,
                             dim3 block, size_t smem, cudaStream_t stream,
                             int cluster, Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

}  // namespace sm90
}  // namespace esme
