// H2: varlen segment-flash attention backward for Hopper (sm_90a), on
// wgmma fed by TMA through warp-specialised mbarrier rings.
//
// Replaces, as the mma.sync form (flash_bwd.cu) did, the three TPU backward
// paths of esme_tpu/ops/flash.py: K4 (:_dq_kernel 475, :_dkv_kernel 511),
// K5 (:_dq_jobs_kernel 552, :_dkv_jobs_kernel 581) and K3 (the fused
// :_dkvq_jobs_kernel 628), and the relayouts around them
// (esme_tpu/ops/headsplit.py:_split_one_kernel_t 114 for v and do, the
// plain :_merge_kernel_t 235 for dv): q, k, v, do are read and dq, dk, dv
// written in the projections' (T, H*D) layout. The function is the
// mma.sync form's, term for term (scale = 1/sqrt(D); lse from H1, fp32,
// base e; delta = rowsum(do . o) from the wrapper):
//   p  = exp(q.k * scale - lse)  (0 across segments),  dp = do.v,
//   ds = p (dp - delta) scale   (fp32),
//   dv += p^T do  (p rounded to bf16),  dk += ds^T q,  dq += ds k  (ds
//   rounded to bf16), fp32 sums, each gradient rounded to bf16 once.
// Head dims 32, 64 and 128; the wrapper sends 16 and 24 to the mma.sync form
// (a 24-column box cannot be read without the next head's columns).
//
// Two deterministic passes, no atomics, no band buffer (so remat='full'
// stays bit-equal):
// - dk/dv: one CTA per (128-row k block, head), two consumer warpgroups
//   of 64 k rows each. K and V of the block come in once by TMA. A
//   producer warp walks the block's q tiles [qstart, qend) (the union of
//   its two 64-row blocks' spans) through a ring of stages<D>() stages:
//   per stage a 64-row q tile and its do tile by TMA, and the tile's
//   segment ids, lse and delta by cp.async, all landing on the
//   stage's "full" mbarrier; consumers hand the stage back on its "empty"
//   mbarrier. Per tile and warpgroup: S^T = K Q^T and dP^T = V dO^T
//   (wgmma, both operands from shared memory, K-major), P^T and dS^T in
//   registers, then dV += P^T dO and dK += dS^T Q (wgmma, A = P^T and
//   dS^T straight from the accumulator registers, B = dO and Q MN-major,
//   the transposed descriptor).
// - dq: one CTA per (128-row q block, head), two consumer warpgroups of
//   64 q rows over the k tiles [kstart, kend) (H1's spans); per tile
//   S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K (K MN-major).
// Each consumer warp decides per tile, by one vote over the tile's segment
// ids (__all_sync), whether its 16 rows and the tile's 64 columns lie in
// one segment; only the tiles where they do not pay the mask. Segment ids
// need not be monotonic: a tile with mixed ids takes the masked path
// whatever their order.
//
// What bounds it on the card: at ESM2-650M's shapes (D = 64, sequences of
// 100-1000 tokens) the operations, 2 D flops per product, same-segment
// pair and head; the two passes make seven products where a fused pass
// makes five (S and dP twice), because a fused pass would sum dq by fp32
// atomics (about 1.7-3.5 GB of reductions per call at the 50k train
// batch) and lose the determinism. The design keeps the tensor cores fed
// from shared memory without register fragments reloaded per use, loads
// run a ring ahead of the products, and the mask is skipped on
// one-segment tiles. Within a warpgroup the products, the exps and the
// next products still run in series; the other warpgroup of the SM fills
// the gaps (PERF.md has the H100's times). At D = 128 the dk/dv kernel
// spills under the 168-register cap of its 384 threads.
//
// Ablation modes ("H7"): each pass's MODE parameter removes one part of
// the work, as tools/decompose_bwd.py:66 dq_variant and :125 dkv_variant
// (K15) do on the TPU, to measure what each costs; their outputs are wrong
// on purpose. Mode 0 is the production pass, and the only one
// esme_segment_flash_bwd_sm90 launches; esme_flash_bwd_sm90_pass
// launches one pass in mode 0 at any D, or in any mode at D = 64. A dropped product is removed
// at compile time (no guarded wgmma). Each warpgroup faces square 64 x 64
// tiles, so dma and no_acc pair a warpgroup's row p with the tile's row or
// column p; the dk/dv pass walks the union of its two 64-row halves'
// spans, in every mode.

#include <limits.h>

#include "sm90_common.cuh"

namespace {

using namespace esme;
using namespace esme::sm90;

constexpr int BKV = 128;  // dk/dv: k rows per CTA (two warpgroups)
constexpr int QT = 64;    // dk/dv: q tile rows
constexpr int BQ = 128;   // dq: q rows per CTA (two warpgroups)
constexpr int KT = 64;    // dq: k tile rows

template <int D>
__host__ __device__ constexpr int stages() { return D > 64 ? 2 : 3; }

// K15's modes, in the order of esme_tpu_torch/tools/decompose_bwd.py:MODES
enum Mode {
  REAL = 0,  // the production passes
  DMA,       // no compute: every element of the tiles read, summed
  MM_ONLY,   // the products alone: p = s, ds = p + dp
  NO_S,      // no S product: s = lse
  NO_DP,     // no dP product: ds = p * scale
  NO_ACC,    // no accumulating products: the gradient gains max(ds)
  NO_EXP,    // p = s / 2 + 0.01 instead of the masked exp
  NO_MASK,   // no segment mask
};

// The modes that keep the segment mask (skipped on one-segment tiles)
template <int MODE>
__host__ __device__ constexpr bool masks() {
  return MODE == REAL || MODE == NO_S || MODE == NO_DP || MODE == NO_ACC;
}

// p of one score (s the raw product, l2 the row's lse in base 2) and ds
// in place of dp, by mode
template <int MODE>
__device__ __forceinline__ float mode_p(float s, float l2, float scale,
                                        float scale_log2) {
  if constexpr (MODE == MM_ONLY) return s * scale;
  else if constexpr (MODE == NO_EXP) return (s * scale) * 0.5f + 0.01f;
  else if constexpr (MODE == NO_S) return exp2f(l2 - l2);   // s = lse
  else return exp2f(s * scale_log2 - l2);
}

template <int MODE>
__device__ __forceinline__ float mode_ds(float p, float dp, float dl,
                                         float scale) {
  if constexpr (MODE == MM_ONLY) return p + dp;
  else if constexpr (MODE == NO_DP) return p * scale;
  else return p * (dp - dl) * scale;
}

__device__ __forceinline__ float smem_bf16(const unsigned char* tile,
                                           int off) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(tile + off));
}

// ---------------------------------------------------------------------------
// dk/dv pass
// ---------------------------------------------------------------------------

template <int D, int MODE>
struct DkvSmem {
  static constexpr int ST = stages<D>();
  static constexpr int KV_TILE = Geo<D>::template tile_bytes<BKV>();
  static constexpr int Q_TILE = Geo<D>::template tile_bytes<QT>();
  static constexpr int K = 0;
  static constexpr int V = K + KV_TILE;
  static constexpr int Q = V + KV_TILE;              // + 2 s Q_TILE
  static constexpr int WORDS = Q + 2 * ST * Q_TILE;  // + s * 3 * QT words
  // NO_ACC: per tile parity and consumer warp, its column maxima of dS^T
  static constexpr int COLMAX = WORDS + ST * 3 * QT * 4;
  static constexpr int BARS =
      align1k(COLMAX + (MODE == NO_ACC ? 2 * 8 * QT * 4 : 0));
  static constexpr int BYTES = BARS + (2 * ST + 1) * 8 + 1024;  // + alignment
};

// P^T and dS^T of one tile in place of S^T and dP^T: this thread's k rows
// r (sk[r]) against the tile's q columns c = 8 j + 2 tq + e
template <int MODE, bool MASK>
__device__ __forceinline__ void dkv_scores(float (&s)[32], float (&dp)[32],
                                           const int* sq, const float* lse,
                                           const float* delta,
                                           const int (&sk)[2], int tq,
                                           float scale, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    const float2 l = *reinterpret_cast<const float2*>(lse + c);
    const float2 dl = *reinterpret_cast<const float2*>(delta + c);
    int2 ids = make_int2(0, 0);
    if constexpr (MASK) ids = *reinterpret_cast<const int2*>(sq + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float l2 = (e ? l.y : l.x) * LOG2E;
      const float dlc = e ? dl.y : dl.x;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float p = mode_p<MODE>(s[i], l2, scale, scale_log2);
        if constexpr (MASK) p = (e ? ids.y : ids.x) == sk[r] ? p : 0.f;
        dp[i] = mode_ds<MODE>(p, dp[i], dlc, scale);
        s[i] = p;
      }
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(3 * 128, 1)
bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg,
                    const int* __restrict__ qstart,
                    const int* __restrict__ qend, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int T, int H, float scale,
                    float scale_log2) {
  using G = Geo<D>;
  using L = DkvSmem<D, MODE>;
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + ST;
  uint64_t* kv_bar = empty + ST;
  auto q_tile = [&](int s) { return smem + L::Q + 2 * s * L::Q_TILE; };
  auto do_tile = [&](int s) { return smem + L::Q + (2 * s + 1) * L::Q_TILE; };
  auto words = [&](int s) {
    return reinterpret_cast<float*>(smem + L::WORDS) + s * 3 * QT;
  };

  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int HD = H * D;
  const int k0 = kb * BKV;
  const int col0 = h * D;
  // the q tiles of the block's two 64-row k blocks, as one span
  int qb0 = qstart[2 * kb], qb1 = qend[2 * kb];
  if (2 * kb + 1 < (T + 63) / 64) {
    qb0 = min(qb0, qstart[2 * kb + 1]);
    qb1 = max(qb1, qend[2 * kb + 1]);
  }
  const int n = max(qb1 - qb0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);   // expect_tx + 32 lanes' cp.async
      mbar_init(&empty[s], 8);       // one per consumer warp
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer warpgroup: its first warp loads, the others leave
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(kv_bar, 2 * L::KV_TILE);
      tma_tile<D, BKV>(smem + L::K, &tm_k, kv_bar, col0, k0);
      tma_tile<D, BKV>(smem + L::V, &tm_v, kv_bar, col0, k0);
    }
    const float* lse_h = lse + (size_t)h * T;
    const float* delta_h = delta + (size_t)h * T;
    for (int it = 0; it < n + ST; ++it) {
      const int s = it % ST;
      // the stage's last round handed back (the tail waits for every
      // round in flight, so nothing lands after the consumers are gone)
      mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (it >= n) continue;
      const int q0 = (qb0 + it) * QT;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::Q_TILE);
        tma_tile<D, QT>(q_tile(s), &tm_q, &full[s], col0, q0);
        tma_tile<D, QT>(do_tile(s), &tm_do, &full[s], col0, q0);
      }
      float* w = words(s);
#pragma unroll
      for (int i = lane; i < QT; i += 32) {
        const int t = q0 + i;
        const bool ok = t < T;
        const int ts = ok ? t : 0;
        cp_async4(smem_u32(w + i), seg + ts, ok);
        cp_async4(smem_u32(w + QT + i), lse_h + ts, ok);
        cp_async4(smem_u32(w + 2 * QT + i), delta_h + ts, ok);
      }
      mbar_arrive_cp_async(&full[s]);
    }
  } else {
    const int warp = (threadIdx.x % 128) >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int row0 = wg * 64 + warp * 16;   // the warp's first k row
    int krow[2], sk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      krow[r] = k0 + row0 + r * 8 + g;
      sk[r] = krow[r] < T ? seg[krow[r]] : INT_MIN;
    }
    // one segment over the warp's 16 k rows?
    const int kid = lane < 16 && k0 + row0 + lane < T ? seg[k0 + row0 + lane]
                                                      : INT_MIN;
    const int kref = __shfl_sync(0xffffffffu, kid, 0);
    const bool kuni = __all_sync(0xffffffffu, lane >= 16 || kid == kref);

    float dka[G::NH][G::HALF_COLS / 2], dva[G::NH][G::HALF_COLS / 2];
#pragma unroll
    for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
      for (int i = 0; i < G::HALF_COLS / 2; ++i) dka[nh][i] = dva[nh][i] = 0.f;

    const uint32_t ks = smem_u32(smem + L::K);
    const uint32_t vs = smem_u32(smem + L::V);
    mbar_wait(kv_bar, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const uint32_t qs = smem_u32(q_tile(s));
      const uint32_t ds = smem_u32(do_tile(s));
      const float* w = words(s);
      const int* sq = reinterpret_cast<const int*>(w);
      const bool uni = masks<MODE>() &&
                       __all_sync(0xffffffffu, kuni && sq[lane] == kref &&
                                                   sq[lane + 32] == kref);

      if constexpr (MODE == DMA) {
        // every element of the four tiles, q row p facing k row p of the
        // warpgroup's half, into dk; the q rows' lse and delta into dv
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = warp * 16 + r * 8 + g;
          const float lp = w[QT + p], dlp = w[2 * QT + p];
#pragma unroll
          for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
            for (int j = 0; j < G::HALF_COLS / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = nh * G::HALF_COLS + 8 * j + 2 * tq + e;
                const int i = 4 * j + 2 * r + e;
                const int qo = tile_offset<D, QT>(p, c);
                const int ko = tile_offset<D, BKV>(wg * 64 + p, c);
                dka[nh][i] += ((smem_bf16(q_tile(s), qo) +
                                smem_bf16(do_tile(s), qo)) +
                               smem_bf16(smem + L::K, ko)) +
                              smem_bf16(smem + L::V, ko);
                dva[nh][i] = (dva[nh][i] + lp) + dlp;
              }
        }
      } else {
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {   // the product a mode drops reads 0
          if constexpr (MODE == NO_S) st[i] = 0.f;
          if constexpr (MODE == NO_DP) dpt[i] = 0.f;
        }
        wgmma_fence();
        if constexpr (MODE != NO_S) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(st, desc_k<D, BKV>(ks, wg * 64, kk),
                         desc_k<D, QT>(qs, 0, kk), kk > 0);
        }
        if constexpr (MODE != NO_DP) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(dpt, desc_k<D, BKV>(vs, wg * 64, kk),
                         desc_k<D, QT>(ds, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (MODE != NO_S) fence_regs(st);
        if constexpr (MODE != NO_DP) fence_regs(dpt);

        if (uni || !masks<MODE>())
          dkv_scores<MODE, false>(st, dpt, sq, w + QT, w + 2 * QT, sk, tq,
                                  scale, scale_log2);
        else
          dkv_scores<MODE, true>(st, dpt, sq, w + QT, w + 2 * QT, sk, tq,
                                 scale, scale_log2);

        if constexpr (MODE == NO_ACC) {
          // dk row p gains the max over the warpgroup's 64 k rows of dS^T's
          // q column p: over the lane's two rows and the 8 lanes of its
          // column, then the warpgroup's four warps through shared memory
          float* colmax = reinterpret_cast<float*>(smem + L::COLMAX) +
                          ((it & 1) * 8 + wg * 4) * QT;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float mx = fmaxf(dpt[4 * j + e], dpt[4 * j + 2 + e]);
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
              if (g == 0) colmax[warp * QT + 8 * j + 2 * tq + e] = mx;
            }
          named_barrier(1 + wg, 128);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = warp * 16 + r * 8 + g;
            float mx = colmax[p];
#pragma unroll
            for (int w4 = 1; w4 < 4; ++w4) mx = fmaxf(mx, colmax[w4 * QT + p]);
#pragma unroll
            for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
              for (int j = 0; j < G::HALF_COLS / 8; ++j) {
                dka[nh][4 * j + 2 * r] += mx;
                dka[nh][4 * j + 2 * r + 1] += mx;
              }
          }
        } else {
          uint32_t pa[4][4], sa[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            acc_to_a(pa[kk], st, kk);
            acc_to_a(sa[kk], dpt, kk);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nh = 0; nh < G::NH; ++nh)
              wgmma_rs(dva[nh], pa[kk], desc_mn<D, QT>(ds, kk, nh));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nh = 0; nh < G::NH; ++nh)
              wgmma_rs(dka[nh], sa[kk], desc_mn<D, QT>(qs, kk, nh));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int nh = 0; nh < G::NH; ++nh) {
            fence_regs(dka[nh]);
            fence_regs(dva[nh]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (krow[r] >= T) continue;
      bf16* dkrow = dk + (size_t)krow[r] * HD + col0;
      bf16* dvrow = dv + (size_t)krow[r] * HD + col0;
#pragma unroll
      for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
        for (int j = 0; j < G::HALF_COLS / 8; ++j) {
          const int c = nh * G::HALF_COLS + 8 * j + 2 * tq;
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(dkrow + c) =
              __floats2bfloat162_rn(dka[nh][i], dka[nh][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvrow + c) =
              __floats2bfloat162_rn(dva[nh][i], dva[nh][i + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// dq pass
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int ST = stages<D>();
  static constexpr int Q_TILE = Geo<D>::template tile_bytes<BQ>();
  static constexpr int K_TILE = Geo<D>::template tile_bytes<KT>();
  static constexpr int Q = 0;
  static constexpr int DO = Q + Q_TILE;
  static constexpr int K = DO + Q_TILE;              // + 2 s K_TILE
  static constexpr int WORDS = K + 2 * ST * K_TILE;  // + s * KT ids
  static constexpr int BARS = align1k(WORDS + ST * KT * 4);
  static constexpr int BYTES = BARS + (2 * ST + 1) * 8 + 1024;
};

// dS of one tile in place of dP: this thread's q rows r against the
// tile's k columns c = 8 j + 2 tq + e, of which the first kn exist
template <int MODE, bool MASK>
__device__ __forceinline__ void dq_scores(float (&s)[32], float (&dp)[32],
                                          const int* skt, const int (&sq)[2],
                                          const float (&l2)[2],
                                          const float (&dl)[2], int kn, int tq,
                                          float scale, float scale_log2) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * tq;
    int2 ids = make_int2(0, 0);
    if constexpr (MASK) ids = *reinterpret_cast<const int2*>(skt + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r + e;
        float p = mode_p<MODE>(s[i], l2[r], scale, scale_log2);
        if constexpr (MASK)
          p = c + e < kn && (e ? ids.y : ids.x) == sq[r] ? p : 0.f;
        dp[i] = mode_ds<MODE>(p, dp[i], dl[r], scale);
      }
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(3 * 128, 1)
bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seg, const int* __restrict__ kstart,
                   const int* __restrict__ kend, bf16* __restrict__ dq, int T,
                   int H, float scale, float scale_log2) {
  using G = Geo<D>;
  using L = DqSmem<D>;
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + ST;
  uint64_t* qdo_bar = empty + ST;
  auto k_tile = [&](int s) { return smem + L::K + 2 * s * L::K_TILE; };
  auto v_tile = [&](int s) { return smem + L::K + (2 * s + 1) * L::K_TILE; };
  auto ids = [&](int s) {
    return reinterpret_cast<int*>(smem + L::WORDS) + s * KT;
  };

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int HD = H * D;
  const int q0 = qb * BQ;
  const int col0 = h * D;
  const int kb0 = kstart[qb];
  const int n = max(kend[qb] - kb0, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);
      mbar_init(&empty[s], 8);
    }
    mbar_init(qdo_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x % 128 >= 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(qdo_bar, 2 * L::Q_TILE);
      tma_tile<D, BQ>(smem + L::Q, &tm_q, qdo_bar, col0, q0);
      tma_tile<D, BQ>(smem + L::DO, &tm_do, qdo_bar, col0, q0);
    }
    for (int it = 0; it < n + ST; ++it) {
      const int s = it % ST;
      mbar_wait(&empty[s], ((it / ST) & 1) ^ 1);
      if (it >= n) continue;
      const int k0 = (kb0 + it) * KT;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::K_TILE);
        tma_tile<D, KT>(k_tile(s), &tm_k, &full[s], col0, k0);
        tma_tile<D, KT>(v_tile(s), &tm_v, &full[s], col0, k0);
      }
#pragma unroll
      for (int i = lane; i < KT; i += 32) {
        const int t = k0 + i;
        cp_async4(smem_u32(ids(s) + i), seg + (t < T ? t : 0), t < T);
      }
      mbar_arrive_cp_async(&full[s]);
    }
  } else {
    const int warp = (threadIdx.x % 128) >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int row0 = wg * 64 + warp * 16;   // the warp's first q row
    int row[2], sq[2];
    float l2[2], dl[2], lr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = q0 + row0 + r * 8 + g;
      const bool in = row[r] < T;
      sq[r] = in ? seg[row[r]] : INT_MIN;
      l2[r] = in ? lse[(size_t)h * T + row[r]] * LOG2E : 0.f;
      dl[r] = in ? delta[(size_t)h * T + row[r]] : 0.f;
      if constexpr (MODE == DMA)
        lr[r] = in ? lse[(size_t)h * T + row[r]] : 0.f;
    }
    const int qid = lane < 16 && q0 + row0 + lane < T ? seg[q0 + row0 + lane]
                                                      : INT_MIN;
    const int qref = __shfl_sync(0xffffffffu, qid, 0);
    const bool quni = __all_sync(0xffffffffu, lane >= 16 || qid == qref);

    float acc[G::NH][G::HALF_COLS / 2];
#pragma unroll
    for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
      for (int i = 0; i < G::HALF_COLS / 2; ++i) acc[nh][i] = 0.f;

    const uint32_t qs = smem_u32(smem + L::Q);
    const uint32_t dos = smem_u32(smem + L::DO);
    mbar_wait(qdo_bar, 0);
    for (int it = 0; it < n; ++it) {
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const uint32_t ks = smem_u32(k_tile(s));
      const uint32_t vs = smem_u32(v_tile(s));
      const int* skt = ids(s);
      const int kn = T - (kb0 + it) * KT;   // the tile's k rows that exist
      const bool uni = masks<MODE>() &&
                       __all_sync(0xffffffffu, quni && kn >= KT &&
                                                   skt[lane] == qref &&
                                                   skt[lane + 32] == qref);

      if constexpr (MODE == DMA) {
        // every element of the q, do, k and v tiles (q row p facing k row
        // p mod KT), then the row's lse and delta
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = row0 + r * 8 + g;
#pragma unroll
          for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
            for (int j = 0; j < G::HALF_COLS / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = nh * G::HALF_COLS + 8 * j + 2 * tq + e;
                const int i = 4 * j + 2 * r + e;
                const int qo = tile_offset<D, BQ>(p, c);
                const int ko = tile_offset<D, KT>(p % KT, c);
                const float z = ((smem_bf16(smem + L::Q, qo) +
                                  smem_bf16(smem + L::DO, qo)) +
                                 smem_bf16(k_tile(s), ko)) +
                                smem_bf16(v_tile(s), ko);
                acc[nh][i] = ((acc[nh][i] + z) + lr[r]) + dl[r];
              }
        }
      } else {
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) {   // the product a mode drops reads 0
          if constexpr (MODE == NO_S) sc[i] = 0.f;
          if constexpr (MODE == NO_DP) dp[i] = 0.f;
        }
        wgmma_fence();
        if constexpr (MODE != NO_S) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(sc, desc_k<D, BQ>(qs, wg * 64, kk),
                         desc_k<D, KT>(ks, 0, kk), kk > 0);
        }
        if constexpr (MODE != NO_DP) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss_n64(dp, desc_k<D, BQ>(dos, wg * 64, kk),
                         desc_k<D, KT>(vs, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (MODE != NO_S) fence_regs(sc);
        if constexpr (MODE != NO_DP) fence_regs(dp);

        if (uni || !masks<MODE>())
          dq_scores<MODE, false>(sc, dp, skt, sq, l2, dl, kn, tq, scale,
                                 scale_log2);
        else
          dq_scores<MODE, true>(sc, dp, skt, sq, l2, dl, kn, tq, scale,
                                scale_log2);

        if constexpr (MODE == NO_ACC) {
          // the row's max of dS over the tile's keys, into every column
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = dp[2 * r];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              mx = fmaxf(mx, fmaxf(dp[4 * j + 2 * r], dp[4 * j + 2 * r + 1]));
#pragma unroll
            for (int off = 1; off < 4; off <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
#pragma unroll
            for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
              for (int j = 0; j < G::HALF_COLS / 8; ++j) {
                acc[nh][4 * j + 2 * r] += mx;
                acc[nh][4 * j + 2 * r + 1] += mx;
              }
          }
        } else {
          uint32_t sa[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) acc_to_a(sa[kk], dp, kk);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nh = 0; nh < G::NH; ++nh)
              wgmma_rs(acc[nh], sa[kk], desc_mn<D, KT>(ks, kk, nh));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int nh = 0; nh < G::NH; ++nh) fence_regs(acc[nh]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= T) continue;
      bf16* out = dq + (size_t)row[r] * HD + col0;
#pragma unroll
      for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
        for (int j = 0; j < G::HALF_COLS / 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(out + nh * G::HALF_COLS + 8 * j +
                                             2 * tq) =
              __floats2bfloat162_rn(acc[nh][i], acc[nh][i + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *seg, *kstart, *kend, *qstart, *qend;
  bf16 *dq, *dk, *dv;
  int T, H;
  float scale;
  cudaStream_t stream;
};

template <int D, int MODE>
cudaError_t launch_dkv(const Args& a) {
  using L = DkvSmem<D, MODE>;
  CUtensorMap tq, tk, tv, tdo;
  const int HD = a.H * D;
  cudaError_t err;
  if ((err = tile_map<D>(&tq, a.q, a.T, HD, QT)) != cudaSuccess ||
      (err = tile_map<D>(&tdo, a.dout, a.T, HD, QT)) != cudaSuccess ||
      (err = tile_map<D>(&tk, a.k, a.T, HD, BKV)) != cudaSuccess ||
      (err = tile_map<D>(&tv, a.v, a.T, HD, BKV)) != cudaSuccess)
    return err;
  auto kernel = bwd_dkv_sm90_kernel<D, MODE>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.T + BKV - 1) / BKV, a.H), 3 * 128, L::BYTES, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.seg, a.qstart, a.qend, a.dk, a.dv,
      a.T, a.H, a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

template <int D, int MODE>
cudaError_t launch_dq(const Args& a) {
  using L = DqSmem<D>;
  CUtensorMap tq, tk, tv, tdo;
  const int HD = a.H * D;
  cudaError_t err;
  if ((err = tile_map<D>(&tq, a.q, a.T, HD, BQ)) != cudaSuccess ||
      (err = tile_map<D>(&tdo, a.dout, a.T, HD, BQ)) != cudaSuccess ||
      (err = tile_map<D>(&tk, a.k, a.T, HD, KT)) != cudaSuccess ||
      (err = tile_map<D>(&tv, a.v, a.T, HD, KT)) != cudaSuccess)
    return err;
  auto kernel = bwd_dq_sm90_kernel<D, MODE>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((a.T + BQ - 1) / BQ, a.H), 3 * 128, L::BYTES, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, a.seg, a.kstart, a.kend, a.dq, a.T,
      a.H, a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

// which = 0: dk/dv; 1: dq
template <int D, int MODE = REAL>
cudaError_t launch_pass(const Args& a, int which) {
  return which == 0 ? launch_dkv<D, MODE>(a) : launch_dq<D, MODE>(a);
}

cudaError_t launch_pass(const Args& a, int D, int which) {
  switch (D) {
    case 32: return launch_pass<32>(a, which);
    case 64: return launch_pass<64>(a, which);
    case 128: return launch_pass<128>(a, which);
    default: return cudaErrorInvalidValue;
  }
}

// One pass in ablation mode `mode`: mode 0 (the production pass) at
// every D, the other modes at D = 64 only (ESM2-650M's head dim)
cudaError_t launch_pass(const Args& a, int D, int which, int mode) {
  if (mode == REAL) return launch_pass(a, D, which);
  if (D != 64) return cudaErrorInvalidValue;
  switch (mode) {
#define ESME_BWD_MODE(M) \
  case M: return launch_pass<64, M>(a, which);
    ESME_BWD_MODE(DMA)
    ESME_BWD_MODE(MM_ONLY)
    ESME_BWD_MODE(NO_S)
    ESME_BWD_MODE(NO_DP)
    ESME_BWD_MODE(NO_ACC)
    ESME_BWD_MODE(NO_EXP)
    ESME_BWD_MODE(NO_MASK)
#undef ESME_BWD_MODE
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* seg,
               const void* kstart, const void* kend, const void* qstart,
               const void* qend, void* dq, void* dk, void* dv, int T, int H,
               float scale, void* stream) {
  return Args{static_cast<const bf16*>(q),      static_cast<const bf16*>(k),
              static_cast<const bf16*>(v),      static_cast<const bf16*>(dout),
              static_cast<const float*>(lse),   static_cast<const float*>(delta),
              static_cast<const int*>(seg),     static_cast<const int*>(kstart),
              static_cast<const int*>(kend),    static_cast<const int*>(qstart),
              static_cast<const int*>(qend),    static_cast<bf16*>(dq),
              static_cast<bf16*>(dk),           static_cast<bf16*>(dv),
              T,
              H,
              scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// Both passes, dk/dv then dq. D in {32, 64, 128}. Returns the cudaError_t
// of the launches (0 on success).
int esme_segment_flash_bwd_sm90(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, const void* seg,
                                const void* kstart, const void* kend,
                                const void* qstart, const void* qend,
                                void* dq, void* dk, void* dv, int T, int H,
                                int D, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, seg, kstart, kend,
                           qstart, qend, dq, dk, dv, T, H, scale, stream);
  const cudaError_t err = launch_pass(a, D, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_pass(a, D, 1);
}

// One pass alone in ablation mode `mode` (kernel H7; decompose_bwd.MODES'
// order): mode 0, the production pass, at D in {32, 64, 128}, to time it;
// the other modes at D = 64 only. which = 0 writes dk and dv, which = 1
// writes dq. Returns the cudaError_t of the launch.
int esme_flash_bwd_sm90_pass(int which, int mode, const void* q,
                             const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta,
                             const void* seg, const void* kstart,
                             const void* kend, const void* qstart,
                             const void* qend, void* dq, void* dk, void* dv,
                             int T, int H, int D, float scale, void* stream) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg, kstart, kend,
                           qstart, qend, dq, dk, dv, T, H, scale, stream);
  return (int)launch_pass(a, D, which, mode);
}

const char* esme_flash_bwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
