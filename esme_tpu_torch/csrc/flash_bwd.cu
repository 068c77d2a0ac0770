// H2: varlen segment-flash attention backward for Hopper (sm_90a).
//
// Replaces the three TPU backward paths of esme_tpu/ops/flash.py, which
// compute the same function: K4, the static-span pair :_dq_kernel (475)
// and :_dkv_kernel (511); K5, the job-list pair :_dq_jobs_kernel (552)
// and :_dkv_jobs_kernel (581); and K3, the fused :_dkvq_jobs_kernel
// (628), which writes per-pair bf16 dq partials into a band and sums
// them in fp32 (here dq is summed in fp32 and rounded once, as K4/K5
// do, so H2 differs from K3 by the partials' rounding). It also folds in
// the relayouts around them: esme_tpu/ops/headsplit.py:
// _split_one_kernel_t (114) for v and do and the plain :_merge_kernel_t
// (235) for dv; q, k, v, do are read and dq, dk, dv written in the
// projections' (T, H*D) layout with row stride H*D. (The rotating
// :_merge_kernel_t, R^T on dq and dk, is kernel H3 with inverse = 1.)
//
// Per same-segment (q, k) pair and head, with scale = 1/sqrt(D):
//   s  = q.k * scale,   p = exp(s - lse)   (0 across segments)
//   dv += p^T do        (p rounded to bf16)
//   dp = do.v,          ds = p (dp - delta) scale   (fp32)
//   dk += ds^T q,  dq += ds k   (ds rounded to bf16)
// with fp32 accumulators and one rounding to bf16 at the end, as K4/K5
// (esme_tpu/ops/flash.py:496-508, 533-549). lse comes from H1 (fp32,
// base e) and delta = rowsum(do . o) from the wrapper.
//
// Two kernels, deterministic, no atomics, no band buffer:
// - dkv: one block per (64-row k block, head); its 4 warps own 16 k
//   rows each and walk the block's own q tiles [qstart, qend) (64 rows
//   each). Per tile: S^T = K Q^T and dP^T = V dO^T on mma.sync, P^T and
//   dS^T in registers, then dV += P^T dO and dK += dS^T Q with the
//   accumulator layouts reused as A operands (no shared-memory round
//   trip).
// - dq: one block per (128-row q block, head), 8 warps of 16 q rows,
//   walking [kstart, kend), the spans H1 walks. Per k tile: S = Q K^T,
//   dP = dO V^T, dS in registers, dQ += dS K.
// Each kernel recomputes S and dP (as K4/K5 do); K3 computes them once
// per pair at the price of the band buffer.
//
// What bounds it on the card: at ESM2-650M's shapes (D = 64, sequences
// of 100-1000 tokens) the least work is five products of 2 D flops per
// same-segment pair and head (2.5x H1's), against q, k, v, do read and
// dq, dk, dv written once, so H2 is bound by operations; the two-kernel
// form does seven products (S and dP twice). The design keeps every
// score-sized intermediate in registers, double-buffers the walked tiles
// with cp.async, and reads fragments with ldmatrix from rows padded by
// 16 bytes; operand fragments are reloaded from shared memory at every
// use instead of held in registers, to leave room for two fp32
// accumulators of D columns. The dkv kernel takes its 64 q columns in
// chunks of NC (32 at D = 128) for the same reason. wgmma, TMA, a fused
// single pass with fp32 atomics for dq, and warp specialisation are
// later work.
//
// Head dims: padded widths DP in {16, 32, 64, 128}; D = 24 runs in the
// DP = 32 kernels with the extra columns zero-filled on load and never
// stored (scale stays 1/sqrt(24)).
//
// Ablation modes ("H7"): each kernel's MODE parameter removes one pass,
// as tools/decompose_bwd.py:66 dq_variant and :125 dkv_variant (K15) do
// on the TPU, to measure what each pass costs; their outputs are wrong on
// purpose. Mode 0 is the production pair, and esme_segment_flash_bwd
// launches only that; esme_segment_flash_bwd_variant launches one kernel
// in any mode, at D = 64 only (ESM2-650M's head dim).
//
// H10, the rectangular form (flash_bwd_dkv_rect_kernel and
// flash_bwd_dq_rect_kernel, the two bodies in mode 0 at every padded width,
// in kernels of their own; the wrapper routes D = 16 and 24 here, as for
// H2): Tq query rows with ids seg_q over Tk key rows with ids seg_k, the
// backward of the TPU kernel K-rect (esme_tpu/ops/flash.py:1083
// _flash_bwd_vjp -> _bwd). The q, do, lse, delta and q-id loads, the dq
// grid and dq's stores are over Tq; the k, v and k-id loads, the dk/dv
// grid and dk's and dv's stores over Tk. A 64-row k block that no query
// shares an id with walks no q tile and writes zeros. Where H10 walks H2's
// span its dq rows are H2's bit for bit.

#include "flash_common.cuh"

namespace {

using namespace esme;

constexpr int BQ = 128;   // dq: q rows per block (8 warps x 16)
constexpr int BK = 64;    // dq: k tile rows
constexpr int BKV = 64;   // dkv: k rows per block (4 warps x 16)
constexpr int BQT = 64;   // dkv: q tile rows

// K15's modes, in the order of esme_tpu_torch/tools/decompose_bwd.py:MODES
enum Mode {
  REAL = 0,
  DMA,       // no compute: every element of the tiles read, summed
  MM_ONLY,   // the products alone: p = s, ds = p + dp
  NO_S,      // no S product: s = lse
  NO_DP,     // no dP product: ds = p * scale
  NO_ACC,    // no accumulating products: the gradient gains max(ds)
  NO_EXP,    // p = s / 2 + 0.01 instead of the masked exp
  NO_MASK,   // no segment mask
};

template <int DP>
struct DqCfg {
  static constexpr int NTHREADS = (BQ / 16) * 32;
  static constexpr int LD = DP + 8;
  static constexpr int QTILE = BQ * LD;
  static constexpr int KTILE = BK * LD;
  // q and do tiles; two stages of (k tile, v tile); two stages of the
  // k tile's segment ids
  static constexpr size_t bytes =
      (size_t)(2 * QTILE + 4 * KTILE) * 2 + 2 * BK * 4;
};

template <int DP>
struct DkvCfg {
  static constexpr int NTHREADS = (BKV / 16) * 32;
  static constexpr int NC = DP <= 64 ? 64 : 32;  // q columns per step
  static constexpr int LD = DP + 8;
  static constexpr int TILE = BKV * LD;          // = BQT * LD
  // k and v tiles; two stages of (q tile, do tile); two stages of the
  // q tile's segment ids, lse and delta
  static constexpr size_t bytes = (size_t)6 * TILE * 2 + 2 * 3 * BQT * 4;
  // NO_ACC: each warp's column maxima of dS^T
  static constexpr size_t colmax_bytes = (size_t)(BKV / 16) * BQT * 4;
};

template <int DP, int MODE>
constexpr size_t dkv_smem() {
  return DkvCfg<DP>::bytes + (MODE == NO_ACC ? DkvCfg<DP>::colmax_bytes : 0);
}

// The dk/dv kernel's body, shared by H2 (and H7) and H10: the queries
// have ids seg over T rows and the keys ids segk over Tk rows; H2's
// kernel passes its one seg and T for both, H10's kernel (RECT) the two
// sides' own. With RECT a k row past Tk is marked by krow = -1 before the
// walk, so Tk is not live across it: at DP = 128 the kernel sits at the
// 255-register cap, and the extra length spilled a register.
template <int DP, int MODE, bool RECT = false>
__device__ __forceinline__ void dkv_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, const int* __restrict__ segk,
    const int* __restrict__ qstart, const int* __restrict__ qend,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Tk, int H, int D,
    float scale, float scale_log2) {
  using C = DkvCfg<DP>;
  constexpr int LD = C::LD;
  constexpr int NC = C::NC;
  constexpr int NN = NC / 8;   // 8-wide score tiles over a column chunk
  constexpr int KD = DP / 16;  // k-steps over the head dim
  constexpr int ND = DP / 8;   // 8-wide output tiles over the head dim
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + C::TILE;
  float* words = reinterpret_cast<float*>(smem + (size_t)6 * C::TILE * 2);

  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int HD = H * D;
  const int k0 = kb * BKV;
  const int col0 = h * D;
  const int qb0 = qstart[kb];
  const int qb1 = qend[kb];

  // this thread's k rows: r = 0 -> g, r = 1 -> g + 8 of the warp's 16
  int krow[2], sk[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    krow[r] = k0 + warp * 16 + r * 8 + g;
    sk[r] = krow[r] < Tk ? segk[krow[r]] : -2;
    if constexpr (RECT) krow[r] = krow[r] < Tk ? krow[r] : -1;
  }

  auto q_tile = [&](int s) { return Ks + (2 + 2 * s) * C::TILE; };
  auto do_tile = [&](int s) { return Ks + (3 + 2 * s) * C::TILE; };
  auto segq = [&](int s) { return reinterpret_cast<int*>(words) + s * 3 * BQT; };
  auto lse_s = [&](int s) { return words + s * 3 * BQT + BQT; };
  auto delta_s = [&](int s) { return words + s * 3 * BQT + 2 * BQT; };
  const float* lse_h = lse + (size_t)h * T;
  const float* delta_h = delta + (size_t)h * T;
  auto load_q = [&](int qb, int s) {
    const int q0 = qb * BQT;
    load_rows<DP, LD, BQT, C::NTHREADS>(q_tile(s), q, q0, T, HD, col0, D);
    load_rows<DP, LD, BQT, C::NTHREADS>(do_tile(s), dout, q0, T, HD, col0, D);
    load_words<C::NTHREADS>(segq(s), seg, q0, BQT, T);
    load_words<C::NTHREADS>(lse_s(s), lse_h, q0, BQT, T);
    load_words<C::NTHREADS>(delta_s(s), delta_h, q0, BQT, T);
  };

  load_rows<DP, LD, BKV, C::NTHREADS>(Ks, k, k0, Tk, HD, col0, D);
  load_rows<DP, LD, BKV, C::NTHREADS>(Vs, v, k0, Tk, HD, col0, D);
  if (qb0 < qb1) load_q(qb0, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;

  for (int qb = qb0; qb < qb1; ++qb) {
    const int s = (qb - qb0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile qb has landed; every warp is done with qb-1
    if (qb + 1 < qb1) load_q(qb + 1, s ^ 1);
    cp_async_commit();

    const bf16* Qt = q_tile(s);
    const bf16* Dt = do_tile(s);
    const int* sq = segq(s);
    const float* ls = lse_s(s);
    const float* dl = delta_s(s);
    const int q0 = qb * BQT;

    if constexpr (MODE == DMA) {
      // every element of the four tiles, q row p facing k row p, into dk;
      // the q rows' lse and delta into dv (the TPU kernel's sums)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = warp * 16 + r * 8 + g;
        const float lp = ls[p], dlp = dl[p];
#pragma unroll
        for (int d = 0; d < ND; ++d)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = p * LD + d * 8 + tq * 2 + e;
            dka[d][2 * r + e] += ((__bfloat162float(Qt[i]) +
                                   __bfloat162float(Dt[i])) +
                                  __bfloat162float(Ks[i])) +
                                 __bfloat162float(Vs[i]);
            dva[d][2 * r + e] = (dva[d][2 * r + e] + lp) + dlp;
          }
      }
    } else {
#pragma unroll
      for (int c0 = 0; c0 < BQT; c0 += NC) {
        // S^T = K Q^T and dP^T = V dO^T for this warp's k rows and the
        // chunk's NC q columns
        float st[NN][4], dpt[NN][4];
#pragma unroll
        for (int j = 0; j < NN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ka[4], va[4];
          if constexpr (MODE != NO_S)
            ldsm_x4(ka, a_addr<LD>(Ks, warp * 16, kk * 16, lane));
          if constexpr (MODE != NO_DP)
            ldsm_x4(va, a_addr<LD>(Vs, warp * 16, kk * 16, lane));
#pragma unroll
          for (int jp = 0; jp < NN / 2; ++jp) {
            uint32_t b[4];
            if constexpr (MODE != NO_S) {
              ldsm_x4(b, b_addr<LD>(Qt, c0 + jp * 16, kk * 16, lane));
              mma_bf16(st[2 * jp], ka, b[0], b[1]);
              mma_bf16(st[2 * jp + 1], ka, b[2], b[3]);
            }
            if constexpr (MODE != NO_DP) {
              ldsm_x4(b, b_addr<LD>(Dt, c0 + jp * 16, kk * 16, lane));
              mma_bf16(dpt[2 * jp], va, b[0], b[1]);
              mma_bf16(dpt[2 * jp + 1], va, b[2], b[3]);
            }
          }
        }

        // P^T into st, dS^T into dpt; lane holds q columns
        // c0 + 8 j + 2 tq + {0, 1} of k rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
        for (int j = 0; j < NN; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + j * 8 + tq * 2 + e;
            const int sqc = q0 + c < T ? sq[c] : -1;
            const float l2 = ls[c] * LOG2E;
            const float dlc = dl[c];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& p = st[j][2 * r + e];
              float& ds = dpt[j][2 * r + e];
              if constexpr (MODE == MM_ONLY)
                p = p * scale;
              else if constexpr (MODE == NO_EXP)
                p = (p * scale) * 0.5f + 0.01f;
              else if constexpr (MODE == NO_MASK)
                p = exp2f(p * scale_log2 - l2);
              else if constexpr (MODE == NO_S)   // s = lse
                p = sqc == sk[r] ? exp2f(ls[c] * LOG2E - l2) : 0.f;
              else
                p = sqc == sk[r] ? exp2f(p * scale_log2 - l2) : 0.f;
              if constexpr (MODE == MM_ONLY)
                ds = p + ds;
              else if constexpr (MODE == NO_DP)
                ds = p * scale;
              else
                ds = p * (ds - dlc) * scale;
            }
          }
        }

        if constexpr (MODE == NO_ACC) {
          // dk row p gains the max over the block's k rows of dS^T's q
          // column p: over the lane's two rows, the 8 lanes of its column,
          // then the warps through shared memory
          static_assert(BKV == BQT && NC == BQT, "no_acc pairs k row p with q column p");
          float* colmax = reinterpret_cast<float*>(smem + C::bytes);
#pragma unroll
          for (int j = 0; j < NN; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float mxc = fmaxf(dpt[j][e], dpt[j][2 + e]);
#pragma unroll
              for (int off = 4; off < 32; off <<= 1)
                mxc = fmaxf(mxc, __shfl_xor_sync(0xffffffffu, mxc, off));
              if (g == 0) colmax[warp * BQT + j * 8 + tq * 2 + e] = mxc;
            }
          __syncthreads();
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = warp * 16 + r * 8 + g;
            float mxr = colmax[p];
#pragma unroll
            for (int w = 1; w < BKV / 16; ++w) mxr = fmaxf(mxr, colmax[w * BQT + p]);
#pragma unroll
            for (int d = 0; d < ND; ++d) {
              dka[d][2 * r] += mxr;
              dka[d][2 * r + 1] += mxr;
            }
          }
        } else {
          // dV += P^T dO and dK += dS^T Q over the chunk's columns
#pragma unroll
          for (int kk = 0; kk < NC / 16; ++kk) {
            uint32_t pa[4], sa[4];
            acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
            acc_to_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
            for (int dp = 0; dp < ND / 2; ++dp) {
              uint32_t b[4];
              ldsm_x4_trans(b, a_addr<LD>(Dt, c0 + kk * 16, dp * 16, lane));
              mma_bf16(dva[2 * dp], pa, b[0], b[1]);
              mma_bf16(dva[2 * dp + 1], pa, b[2], b[3]);
              ldsm_x4_trans(b, a_addr<LD>(Qt, c0 + kk * 16, dp * 16, lane));
              mma_bf16(dka[2 * dp], sa, b[0], b[1]);
              mma_bf16(dka[2 * dp + 1], sa, b[2], b[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (RECT ? krow[r] < 0 : krow[r] >= Tk) continue;
    bf16* dkrow = dk + (size_t)krow[r] * HD + col0;
    bf16* dvrow = dv + (size_t)krow[r] * HD + col0;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int c = d * 8 + tq * 2;
      if (c < D) {
        *reinterpret_cast<__nv_bfloat162*>(dkrow + c) =
            __floats2bfloat162_rn(dka[d][2 * r], dka[d][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvrow + c) =
            __floats2bfloat162_rn(dva[d][2 * r], dva[d][2 * r + 1]);
      }
    }
  }
}

template <int DP, int MODE>
__global__ void __launch_bounds__(DkvCfg<DP>::NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg,
                     const int* __restrict__ qstart,
                     const int* __restrict__ qend, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int H, int D, float scale,
                     float scale_log2) {
  dkv_body<DP, MODE>(q, k, v, dout, lse, delta, seg, seg, qstart, qend, dk,
                     dv, T, T, H, D, scale, scale_log2);
}

// H10's dk/dv kernel: Tq query rows with ids seg_q over Tk key rows with
// ids seg_k
template <int DP>
__global__ void __launch_bounds__(DkvCfg<DP>::NTHREADS)
flash_bwd_dkv_rect_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    const int* __restrict__ qstart, const int* __restrict__ qend,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H,
    int D, float scale, float scale_log2) {
  dkv_body<DP, REAL, true>(q, k, v, dout, lse, delta, seg_q, seg_k, qstart,
                           qend, dk, dv, Tq, Tk, H, D, scale, scale_log2);
}

// The dq kernel's body, shared by H2 (and H7) and H10, with the two sides'
// ids and lengths as in dkv_body
template <int DP, int MODE>
__device__ __forceinline__ void dq_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg, const int* __restrict__ segk_g,
    const int* __restrict__ kstart, const int* __restrict__ kend,
    bf16* __restrict__ dq, int T, int Tk, int H, int D, float scale,
    float scale_log2) {
  using C = DqCfg<DP>;
  constexpr int LD = C::LD;
  constexpr int KD = DP / 16;
  constexpr int ND = DP / 8;
  constexpr int NK = BK / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* DOs = Qs + C::QTILE;
  int* segk = reinterpret_cast<int*>(smem +
                                     (size_t)(2 * C::QTILE + 4 * C::KTILE) * 2);

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int HD = H * D;
  const int q0 = qb * BQ;
  const int col0 = h * D;
  const int kb0 = kstart[qb];
  const int kb1 = kend[qb];

  // this thread's q rows (rows past T match nothing and are not written)
  int row[2], sq[2];
  float l2[2], dl[2], lr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + warp * 16 + r * 8 + g;
    const bool in = row[r] < T;
    sq[r] = in ? seg[row[r]] : -2;
    l2[r] = in ? lse[(size_t)h * T + row[r]] * LOG2E : 0.f;
    dl[r] = in ? delta[(size_t)h * T + row[r]] : 0.f;
    if constexpr (MODE == DMA) lr[r] = in ? lse[(size_t)h * T + row[r]] : 0.f;
  }

  auto k_tile = [&](int s) { return DOs + C::QTILE + 2 * s * C::KTILE; };
  auto v_tile = [&](int s) { return DOs + C::QTILE + (2 * s + 1) * C::KTILE; };
  auto load_kv = [&](int kb, int s) {
    const int k0 = kb * BK;
    load_rows<DP, LD, BK, C::NTHREADS>(k_tile(s), k, k0, Tk, HD, col0, D);
    load_rows<DP, LD, BK, C::NTHREADS>(v_tile(s), v, k0, Tk, HD, col0, D);
    load_words<C::NTHREADS>(segk + s * BK, segk_g, k0, BK, Tk);
  };

  load_rows<DP, LD, BQ, C::NTHREADS>(Qs, q, q0, T, HD, col0, D);
  load_rows<DP, LD, BQ, C::NTHREADS>(DOs, dout, q0, T, HD, col0, D);
  if (kb0 < kb1) load_kv(kb0, 0);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int d = 0; d < ND; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;

  for (int kb = kb0; kb < kb1; ++kb) {
    const int s = (kb - kb0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kb has landed; every warp is done with kb-1
    if (kb + 1 < kb1) load_kv(kb + 1, s ^ 1);
    cp_async_commit();

    const bf16* Kt = k_tile(s);
    const bf16* Vt = v_tile(s);
    const int* sk = segk + s * BK;
    const int k0 = kb * BK;

    if constexpr (MODE == DMA) {
      // every element of the q, do, k and v tiles (q row p facing k row
      // p mod BK), then the row's lse and delta (the TPU kernel's sums)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = warp * 16 + r * 8 + g;
#pragma unroll
        for (int d = 0; d < ND; ++d)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = d * 8 + tq * 2 + e;
            const int iq = p * LD + c, ik = (p % BK) * LD + c;
            const float z = ((__bfloat162float(Qs[iq]) +
                              __bfloat162float(DOs[iq])) +
                             __bfloat162float(Kt[ik])) +
                            __bfloat162float(Vt[ik]);
            acc[d][2 * r + e] = ((acc[d][2 * r + e] + z) + lr[r]) + dl[r];
          }
      }
    } else {
      // S = Q K^T and dP = dO V^T for this warp's rows and the tile's keys
      float sc[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4], da[4];
        if constexpr (MODE != NO_S)
          ldsm_x4(qa, a_addr<LD>(Qs, warp * 16, kk * 16, lane));
        if constexpr (MODE != NO_DP)
          ldsm_x4(da, a_addr<LD>(DOs, warp * 16, kk * 16, lane));
#pragma unroll
        for (int jp = 0; jp < NK / 2; ++jp) {
          uint32_t b[4];
          if constexpr (MODE != NO_S) {
            ldsm_x4(b, b_addr<LD>(Kt, jp * 16, kk * 16, lane));
            mma_bf16(sc[2 * jp], qa, b[0], b[1]);
            mma_bf16(sc[2 * jp + 1], qa, b[2], b[3]);
          }
          if constexpr (MODE != NO_DP) {
            ldsm_x4(b, b_addr<LD>(Vt, jp * 16, kk * 16, lane));
            mma_bf16(dp[2 * jp], da, b[0], b[1]);
            mma_bf16(dp[2 * jp + 1], da, b[2], b[3]);
          }
        }
      }

      // dS into sc; lane holds keys 8 j + 2 tq + {0, 1} of rows g and g + 8
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + tq * 2 + e;
          const int skc = k0 + c < Tk ? sk[c] : -1;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            if constexpr (MODE == REAL) {
              const float p = skc == sq[r]
                                  ? exp2f(sc[j][2 * r + e] * scale_log2 - l2[r])
                                  : 0.f;
              sc[j][2 * r + e] = p * (dp[j][2 * r + e] - dl[r]) * scale;
            } else {
              float p;
              if constexpr (MODE == MM_ONLY)
                p = sc[j][2 * r + e] * scale;
              else if constexpr (MODE == NO_EXP)
                p = (sc[j][2 * r + e] * scale) * 0.5f + 0.01f;
              else if constexpr (MODE == NO_MASK)
                p = exp2f(sc[j][2 * r + e] * scale_log2 - l2[r]);
              else if constexpr (MODE == NO_S)   // s = lse
                p = skc == sq[r] ? exp2f(l2[r] - l2[r]) : 0.f;
              else
                p = skc == sq[r] ? exp2f(sc[j][2 * r + e] * scale_log2 - l2[r])
                                 : 0.f;
              if constexpr (MODE == MM_ONLY)
                sc[j][2 * r + e] = p + dp[j][2 * r + e];
              else if constexpr (MODE == NO_DP)
                sc[j][2 * r + e] = p * scale;
              else
                sc[j][2 * r + e] = p * (dp[j][2 * r + e] - dl[r]) * scale;
            }
          }
        }
      }

      if constexpr (MODE == NO_ACC) {
        // the row's max of dS over the tile's keys, into every column
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mxr = sc[0][2 * r];
#pragma unroll
          for (int j = 0; j < NK; ++j)
            mxr = fmaxf(mxr, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            mxr = fmaxf(mxr, __shfl_xor_sync(0xffffffffu, mxr, off));
#pragma unroll
          for (int d = 0; d < ND; ++d) {
            acc[d][2 * r] += mxr;
            acc[d][2 * r + 1] += mxr;
          }
        }
      } else {
        // dQ += dS K
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t sa[4];
          acc_to_a(sa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
          for (int dpi = 0; dpi < ND / 2; ++dpi) {
            uint32_t b[4];
            ldsm_x4_trans(b, a_addr<LD>(Kt, kk * 16, dpi * 16, lane));
            mma_bf16(acc[2 * dpi], sa, b[0], b[1]);
            mma_bf16(acc[2 * dpi + 1], sa, b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    bf16* out = dq + (size_t)row[r] * HD + col0;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      const int c = d * 8 + tq * 2;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(out + c) =
            __floats2bfloat162_rn(acc[d][2 * r], acc[d][2 * r + 1]);
    }
  }
}

template <int DP, int MODE>
__global__ void __launch_bounds__(DqCfg<DP>::NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg,
                    const int* __restrict__ kstart,
                    const int* __restrict__ kend, bf16* __restrict__ dq,
                    int T, int H, int D, float scale, float scale_log2) {
  dq_body<DP, MODE>(q, k, v, dout, lse, delta, seg, seg, kstart, kend, dq, T,
                    T, H, D, scale, scale_log2);
}

// H10's dq kernel: Tq query rows with ids seg_q over Tk key rows with ids
// seg_k
template <int DP>
__global__ void __launch_bounds__(DqCfg<DP>::NTHREADS)
flash_bwd_dq_rect_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ seg_q, const int* __restrict__ seg_k,
    const int* __restrict__ kstart, const int* __restrict__ kend,
    bf16* __restrict__ dq, int Tq, int Tk, int H, int D, float scale,
    float scale_log2) {
  dq_body<DP, REAL>(q, k, v, dout, lse, delta, seg_q, seg_k, kstart, kend, dq,
                    Tq, Tk, H, D, scale, scale_log2);
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *seg, *kstart, *kend, *qstart, *qend;
  bf16 *dq, *dk, *dv;
  int T, H, D;
  float scale;
  cudaStream_t stream;
};

template <int DP, int MODE>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = dkv_smem<DP, MODE>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DP, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DP, MODE>
      <<<dim3((a.T + BKV - 1) / BKV, a.H), DkvCfg<DP>::NTHREADS, smem,
         a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.seg, a.qstart,
                     a.qend, a.dk, a.dv, a.T, a.H, a.D, a.scale,
                     a.scale * LOG2E);
  return cudaGetLastError();
}

template <int DP, int MODE>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = DqCfg<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DP, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP, MODE>
      <<<dim3((a.T + BQ - 1) / BQ, a.H), DqCfg<DP>::NTHREADS, smem,
         a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.seg, a.kstart,
                     a.kend, a.dq, a.T, a.H, a.D, a.scale, a.scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const Args& a) {
  const cudaError_t err = launch_dkv<DP, REAL>(a);
  if (err != cudaSuccess) return err;
  return launch_dq<DP, REAL>(a);
}

// H10: both kernels, dk/dv then dq, over Tq query rows (q, do, dq, lse,
// delta; seg_q) and Tk key rows (k, v, dk, dv; seg_k)
template <int DP>
int launch_rect(const Args& a, const int* seg_k, int Tk) {
  const size_t dkv_bytes = dkv_smem<DP, REAL>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_rect_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_rect_kernel<DP>
      <<<dim3((Tk + BKV - 1) / BKV, a.H), DkvCfg<DP>::NTHREADS, dkv_bytes,
         a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.seg, seg_k,
                     a.qstart, a.qend, a.dk, a.dv, a.T, Tk, a.H, a.D, a.scale,
                     a.scale * LOG2E);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t dq_bytes = DqCfg<DP>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_rect_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_rect_kernel<DP>
      <<<dim3((a.T + BQ - 1) / BQ, a.H), DqCfg<DP>::NTHREADS, dq_bytes,
         a.stream>>>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.seg, seg_k,
                     a.kstart, a.kend, a.dq, a.T, Tk, a.H, a.D, a.scale,
                     a.scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 on success).
int esme_segment_flash_bwd(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* seg,
                           const void* kstart, const void* kend,
                           const void* qstart, const void* qend, void* dq,
                           void* dk, void* dv, int T, int H, int D,
                           float scale, void* stream) {
  const Args a{static_cast<const esme::bf16*>(q),
               static_cast<const esme::bf16*>(k),
               static_cast<const esme::bf16*>(v),
               static_cast<const esme::bf16*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(seg),
               static_cast<const int*>(kstart),
               static_cast<const int*>(kend),
               static_cast<const int*>(qstart),
               static_cast<const int*>(qend),
               static_cast<esme::bf16*>(dq),
               static_cast<esme::bf16*>(dk),
               static_cast<esme::bf16*>(dv),
               T,
               H,
               D,
               scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return (int)launch<16>(a);
    case 24:
    case 32: return (int)launch<32>(a);
    case 64: return (int)launch<64>(a);
    case 128: return (int)launch<128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One of H2's kernels (which = 0: dk/dv, 1: dq) in ablation mode `mode`
// (enum Mode), D = 64 only; the other kernel's outputs are not written.
// Returns the cudaError_t of the launch (0 on success).
int esme_segment_flash_bwd_variant(int which, int mode, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* seg,
                                   const void* kstart, const void* kend,
                                   const void* qstart, const void* qend,
                                   void* dq, void* dk, void* dv, int T, int H,
                                   int D, float scale, void* stream) {
  const Args a{static_cast<const esme::bf16*>(q),
               static_cast<const esme::bf16*>(k),
               static_cast<const esme::bf16*>(v),
               static_cast<const esme::bf16*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(seg),
               static_cast<const int*>(kstart),
               static_cast<const int*>(kend),
               static_cast<const int*>(qstart),
               static_cast<const int*>(qend),
               static_cast<esme::bf16*>(dq),
               static_cast<esme::bf16*>(dk),
               static_cast<esme::bf16*>(dv),
               T,
               H,
               D,
               scale,
               static_cast<cudaStream_t>(stream)};
  if (D != 64 || (which != 0 && which != 1)) return (int)cudaErrorInvalidValue;
#define ESME_BWD_MODE(M) \
  case M: return (int)(which == 0 ? launch_dkv<64, M>(a) : launch_dq<64, M>(a));
  switch (mode) {
    ESME_BWD_MODE(REAL)
    ESME_BWD_MODE(DMA)
    ESME_BWD_MODE(MM_ONLY)
    ESME_BWD_MODE(NO_S)
    ESME_BWD_MODE(NO_DP)
    ESME_BWD_MODE(NO_ACC)
    ESME_BWD_MODE(NO_EXP)
    ESME_BWD_MODE(NO_MASK)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ESME_BWD_MODE
}

// H10: H2 with per-side ids and lengths, q, do and dq (Tq, H*D), k, v,
// dk and dv (Tk, H*D), lse and delta (H, Tq). Returns the cudaError_t of
// the launches (0 on success).
int esme_segment_flash_bwd_rect(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* kstart, const void* kend, const void* qstart,
    const void* qend, void* dq, void* dk, void* dv, int Tq, int Tk, int H,
    int D, float scale, void* stream) {
  const Args a{static_cast<const esme::bf16*>(q),
               static_cast<const esme::bf16*>(k),
               static_cast<const esme::bf16*>(v),
               static_cast<const esme::bf16*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const int*>(seg_q),
               static_cast<const int*>(kstart),
               static_cast<const int*>(kend),
               static_cast<const int*>(qstart),
               static_cast<const int*>(qend),
               static_cast<esme::bf16*>(dq),
               static_cast<esme::bf16*>(dk),
               static_cast<esme::bf16*>(dv),
               Tq,
               H,
               D,
               scale,
               static_cast<cudaStream_t>(stream)};
  const int* sk = static_cast<const int*>(seg_k);
  switch (D) {
    case 16: return launch_rect<16>(a, sk, Tk);
    case 24:
    case 32: return launch_rect<32>(a, sk, Tk);
    case 64: return launch_rect<64>(a, sk, Tk);
    case 128: return launch_rect<128>(a, sk, Tk);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* esme_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
