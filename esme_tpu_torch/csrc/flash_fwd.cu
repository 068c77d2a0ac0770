// H1: varlen segment-flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernels esme_tpu/ops/flash.py:_fwd_kernel (static
// k-span sweep) and :_fwd_jobs_kernel (list of real (q-block, k-tile)
// jobs), and folds in the pure relayouts around them,
// esme_tpu/ops/headsplit.py:_split_one_kernel_t (v) and :_merge_kernel_t
// (o): q, k, v are read and o is written in place in the projections'
// (T, H*D) layout, with row stride H*D.
//
// One block per (q block of 128 rows, head). The block walks its own k tiles [kstart, kend) from block_spans, so
// the job list and the static span sweep are one kernel; there is no
// job budget and so nothing to poison on overflow. Math as on the TPU:
// scores masked to -1e30 where seg_k != seg_q, online softmax with m, l
// and the accumulator in fp32, scale 1/sqrt(D), rows with l == 0 kept
// finite, lse = m + log(l). (The softmax runs in base 2 on scores
// pre-multiplied by log2(e); lse is returned in base e.)
//
// What bounds it on the card: at ESM2-650M's shapes (D = 64, sequences
// of 100-1000 tokens) a 128 x 64 tile is 2 MFLOP of tensor-core work
// against 16 KB of k/v, so the kernel is bound by operations, and the
// cost to keep down is everything around the products. The design,
// FlashAttention-2's on mma.sync: q fragments stay in registers for the
// whole span; each warp keeps its scores, the softmax state and the
// output accumulator of 32 q rows (16 for D = 128, where registers run
// out) in registers, so each k/v fragment read from shared memory feeds
// two products; the scores' accumulator layout is reused as the A
// operand of P V without going through shared memory; row max and sum
// need only shuffles within a quad of lanes; k/v tiles arrive by
// cp.async, double-buffered, so the next tile's load overlaps this
// tile's products; ldmatrix feeds the fragments from shared memory rows
// padded by 16 bytes so its reads are free of bank conflicts. wgmma, TMA
// and warp specialisation are later work.
//
// Head dims: the kernel is built for padded widths DP in {16, 32, 64,
// 128}; D = 24 runs in the DP = 32 kernel with the extra columns
// zero-filled on load (scale stays 1/sqrt(24)).
//
// Ablation modes ("H6"): the kernel's MODE parameter removes one pass,
// as tools/flash_variants.py:32 variant_kernel (K17) does on the TPU, to
// measure what each pass costs; their outputs are wrong on purpose.
// Mode 0 is the production kernel, and esme_segment_flash_fwd launches
// only that one; esme_segment_flash_fwd_variant launches any mode, at
// D = 64 only (ESM2-650M's head dim; `nopv` needs D == BK).
//
// H9, the rectangular form (flash_fwd_rect_kernel, the body in mode 0 at
// every padded width, in a kernel of its own; the wrapper routes D = 16
// and 24 here, as for H1): Tq query rows with ids seg_q over Tk key rows
// with ids seg_k, the forward of the TPU kernel K-rect
// (esme_tpu/ops/flash.py:1168 flash_rect_attention -> _fwd). The k/v and
// id loads read seg_k and zero-fill past Tk, and the key mask tests Tk;
// the q rows, the grid, o and lse stay on the query side. Nothing else
// differs: where H9 walks H1's span (a rank whose first row starts a q
// block), its o and lse are H1's bit for bit. A q block whose span is
// empty (no key shares its ids) walks no tile: o = 0, and lse is the
// running max of no key, -1e30 in base 2, times ln 2 (EMPTY_LSE in
// ops/flash.py).

#include "flash_common.cuh"

namespace {

using namespace esme;

constexpr int BQ = 128;
constexpr int BK = 64;

// K17's modes in its order (esme_tpu_torch/tools/flash_variants.py:MODES)
enum Mode {
  BASELINE = 0,
  NOALPHA,   // keep the max; no rescale of l and o by alpha
  MAXFREE,   // no max: p = exp(s - 20), no rescale
  SUMFREE,   // l sums only each tile's first key
  NOMAX,     // no max: p = exp(s), no rescale
  NOMASK,    // no segment mask
  NOEXP,     // p = s / 2 + 0.1 instead of exp, no max, no rescale
  BF16EXP,   // exp of bf16 (the SFU's packed bf16 form)
  NOPV,      // no P V product: o accumulates p's first 64 keys
  NOQK,      // no Q K^T product: s = o[:, 0] + k[:, 0]
  NOTHING,   // no compute: one element of every loaded tile into o
};

// Per head width: MT 16-row m-tiles per warp (two where the registers
// allow, so each k/v fragment read from shared memory feeds two
// products), hence NWARPS warps per 128-row q block. Shared memory: the
// q tile, two stages of (k tile, v tile), two stages of the k tile's
// segment ids; rows padded to DP + 8 bf16.
template <int DP>
struct Cfg {
  static constexpr int MT = DP <= 64 ? 2 : 1;
  static constexpr int NWARPS = BQ / (16 * MT);
  static constexpr int NTHREADS = NWARPS * 32;
  static constexpr int LD = DP + 8;
  static constexpr int QTILE = BQ * LD;
  static constexpr int KTILE = BK * LD;
  static constexpr size_t bytes = (size_t)(QTILE + 4 * KTILE) * 2 + 2 * BK * 4;
};

// The kernel's body, shared by H1 (and H6) and H9: the queries have ids
// seg over T rows and the keys ids segk_g over Tk rows; H1's kernel passes
// its one seg and T for both, H9's kernel the two sides' own.
template <int DP, int MODE>
__device__ __forceinline__ void fwd_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ seg,
    const int* __restrict__ segk_g, const int* __restrict__ kstart,
    const int* __restrict__ kend, bf16* __restrict__ o,
    float* __restrict__ lse, int T, int Tk, int H, int D, float scale_log2) {
  using C = Cfg<DP>;
  constexpr int LD = C::LD;
  constexpr int MT = C::MT;
  constexpr int KD = DP / 16;  // k-steps over the head dim (q k^T)
  constexpr int ND = DP / 8;   // 8-wide output tiles over the head dim
  constexpr int NK = BK / 8;   // 8-wide score tiles over the keys
  // modes in which m keeps its start value (-1e30, which the TPU kernel
  // holds in base e) and alpha is 1
  constexpr bool FIXED_M =
      MODE == MAXFREE || MODE == NOMAX || MODE == NOEXP || MODE == NOTHING;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  int* segk = reinterpret_cast<int*>(smem + (size_t)(C::QTILE + 4 * C::KTILE) * 2);

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // row within an 8-row half of an m-tile
  const int tq = lane & 3;  // column pair within an 8-wide tile
  const int HD = H * D;
  const int q0 = qb * BQ;
  const int col0 = h * D;
  const int kb0 = kstart[qb];
  const int kb1 = kend[qb];

  // this thread's q rows: m-tile m, half r (rows past T match nothing
  // and are not written)
  int row[MT][2], sq[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[m][r] = q0 + (warp * MT + m) * 16 + r * 8 + g;
      sq[m][r] = row[m][r] < T ? seg[row[m][r]] : -2;
    }

  auto k_tile = [&](int s) { return Qs + C::QTILE + 2 * s * C::KTILE; };
  auto v_tile = [&](int s) { return Qs + C::QTILE + (2 * s + 1) * C::KTILE; };
  auto load_kv = [&](int kb, int s) {
    const int k0 = kb * BK;
    load_rows<DP, LD, BK, C::NTHREADS>(k_tile(s), k, k0, Tk, HD, col0, D);
    load_rows<DP, LD, BK, C::NTHREADS>(v_tile(s), v, k0, Tk, HD, col0, D);
    for (int i = threadIdx.x; i < BK; i += C::NTHREADS) {
      const int t = k0 + i;
      cp_async4(smem_u32(segk + s * BK + i), segk_g + (t < Tk ? t : 0),
                t < Tk);
    }
  };

  load_rows<DP, LD, BQ, C::NTHREADS>(Qs, q, q0, T, HD, col0, D);
  if (kb0 < kb1) load_kv(kb0, 0);
  cp_async_commit();

  float mrun[MT][2], lrun[MT][2];  // running row max (base 2); this
                                   // lane's share of the row sums
  float acc[MT][ND][4];
  uint32_t qf[MT][KD][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    mrun[m][0] = mrun[m][1] = NEG_INF;
    lrun[m][0] = lrun[m][1] = 0.f;
#pragma unroll
    for (int d = 0; d < ND; ++d)
      acc[m][d][0] = acc[m][d][1] = acc[m][d][2] = acc[m][d][3] = 0.f;
  }

  for (int kb = kb0; kb < kb1; ++kb) {
    const int s = (kb - kb0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kb has landed; every warp is done with kb-1
    if (kb == kb0) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ldsm_x4(qf[m][kk],
                  smem_u32(Qs + ((warp * MT + m) * 16 + (lane & 7) +
                                 ((lane >> 3) & 1) * 8) * LD +
                           kk * 16 + (lane >> 4) * 8));
    }
    if (kb + 1 < kb1) load_kv(kb + 1, s ^ 1);
    cp_async_commit();

    const bf16* Kt = k_tile(s);
    const bf16* Vt = v_tile(s);
    const int* sk = segk + s * BK;

    if constexpr (MODE == NOTHING) {
      // the first element of the q, k, v and segment-id tiles, in the
      // TPU kernel's order, added to every accumulator
      const float t = (((__bfloat162float(Qs[0]) + __bfloat162float(Kt[0])) +
                        __bfloat162float(Vt[0])) +
                       (float)seg[q0]) +
                      (float)sk[0];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int d = 0; d < ND; ++d)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][d][e] += t;
    } else {
      // S = Q K^T for this warp's rows and the tile's 64 keys
      float sc[MT][NK][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NK; ++j)
          sc[m][j][0] = sc[m][j][1] = sc[m][j][2] = sc[m][j][3] = 0.f;
      if constexpr (MODE == NOQK) {
        // s = o[row, 0] + k[key, 0], unscaled: column 0 of the accumulator
        // lives in the quad's lane tq = 0
        float a0[MT][2];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            a0[m][r] = __shfl_sync(0xffffffffu, acc[m][0][2 * r], lane & ~3);
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kc = __bfloat162float(Kt[(j * 8 + tq * 2 + e) * LD]);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int r = 0; r < 2; ++r) sc[m][j][2 * r + e] = a0[m][r] + kc;
          }
      } else {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int jp = 0; jp < NK / 2; ++jp) {
            uint32_t b[4];
            ldsm_x4(b, smem_u32(Kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                                kk * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_bf16(sc[m][2 * jp], qf[m][kk], b[0], b[1]);
              mma_bf16(sc[m][2 * jp + 1], qf[m][kk], b[2], b[3]);
            }
          }
        }
      }

      // mask, scale, online softmax; lane holds keys 8j + 2tq + {0, 1} of
      // rows g (r = 0) and g + 8 (r = 1) of each m-tile
      const int k0 = kb * BK;
      float mx[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) mx[m][0] = mx[m][1] = NEG_INF;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + tq * 2 + e;
          const int skc = k0 + c < Tk ? sk[c] : -1;
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& x = sc[m][j][2 * r + e];
              if constexpr (MODE == NOMASK)
                x = x * scale_log2;
              else if constexpr (MODE == NOEXP)  // base e, as the TPU's s
                x = skc == sq[m][r] ? x * (scale_log2 * LN2) : NEG_INF;
              else if constexpr (MODE == NOQK)   // s is not scaled there
                x = skc == sq[m][r] ? x * LOG2E : NEG_INF;
              else
                x = skc == sq[m][r] ? x * scale_log2 : NEG_INF;
              if constexpr (!FIXED_M) mx[m][r] = fmaxf(mx[m][r], x);
            }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mn = mrun[m][r], alpha = 1.f;
          if constexpr (!FIXED_M) {
#pragma unroll
            for (int off = 1; off < 4; off <<= 1)
              mx[m][r] = fmaxf(mx[m][r], __shfl_xor_sync(0xffffffffu, mx[m][r], off));
            mn = fmaxf(mrun[m][r], mx[m][r]);
            if constexpr (MODE != NOALPHA) alpha = exp2f(mrun[m][r] - mn);
            mrun[m][r] = mn;
          }
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < NK; ++j) {
            if constexpr (MODE == BF16EXP) {
              const uint32_t p2 = ex2_bf16x2(
                  pack_bf16(sc[m][j][2 * r] - mn, sc[m][j][2 * r + 1] - mn));
              sc[m][j][2 * r] = bf16_lo(p2);
              sc[m][j][2 * r + 1] = bf16_hi(p2);
              ps += sc[m][j][2 * r];
              ps += sc[m][j][2 * r + 1];
            } else {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& p = sc[m][j][2 * r + e];
                if constexpr (MODE == NOEXP)
                  p = p * 0.5f + 0.1f;
                else if constexpr (MODE == MAXFREE)
                  p = exp2f(p - 20.f * LOG2E);
                else if constexpr (MODE == NOMAX)
                  p = exp2f(p);
                else
                  p = exp2f(p - mn);
                ps += p;
              }
            }
          }
          if constexpr (MODE == SUMFREE)  // the tile's first key only
            ps = tq == 0 ? sc[m][0][2 * r] : 0.f;
          if constexpr (MODE == NOALPHA || FIXED_M) {
            lrun[m][r] += ps;
          } else {
            lrun[m][r] = lrun[m][r] * alpha + ps;
#pragma unroll
            for (int d = 0; d < ND; ++d) {
              acc[m][d][2 * r] *= alpha;
              acc[m][d][2 * r + 1] *= alpha;
            }
          }
        }
      }

      if constexpr (MODE == NOPV) {
        // o accumulates p's first 64 keys, unrounded: with BK = D = 64 the
        // score tiles and the output tiles share one layout
        static_assert(DP == BK, "nopv needs D == BK");
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int d = 0; d < ND; ++d)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][d][e] += sc[m][d][e];
      } else {
        // O += P V: the scores' accumulator layout is P's A-operand layout
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t pa[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            pa[m][0] = pack_bf16(sc[m][2 * kk][0], sc[m][2 * kk][1]);
            pa[m][1] = pack_bf16(sc[m][2 * kk][2], sc[m][2 * kk][3]);
            pa[m][2] = pack_bf16(sc[m][2 * kk + 1][0], sc[m][2 * kk + 1][1]);
            pa[m][3] = pack_bf16(sc[m][2 * kk + 1][2], sc[m][2 * kk + 1][3]);
          }
#pragma unroll
          for (int dp = 0; dp < ND / 2; ++dp) {
            uint32_t b[4];
            ldsm_x4_trans(
                b, smem_u32(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            dp * 16 + (lane >> 4) * 8));
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_bf16(acc[m][2 * dp], pa[m], b[0], b[1]);
              mma_bf16(acc[m][2 * dp + 1], pa[m], b[2], b[3]);
            }
          }
        }
      }
    }
  }
  cp_async_wait_all();

  // epilogue: full row sums, o = acc / l into (T, H*D), lse into (H, T)
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = lrun[m][r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (row[m][r] >= T) continue;
      l = l == 0.f ? 1.f : l;
      const float inv = 1.f / l;
      bf16* orow = o + (size_t)row[m][r] * HD + col0;
#pragma unroll
      for (int d = 0; d < ND; ++d) {
        const int c = d * 8 + tq * 2;
        if (c < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
              acc[m][d][2 * r] * inv, acc[m][d][2 * r + 1] * inv);
      }
      if (tq == 0) {
        if constexpr (FIXED_M)
          lse[(size_t)h * T + row[m][r]] = NEG_INF + logf(l);
        else
          lse[(size_t)h * T + row[m][r]] = mrun[m][r] * LN2 + logf(l);
      }
    }
  }
}

template <int DP, int MODE>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const int* __restrict__ seg,
                 const int* __restrict__ kstart,
                 const int* __restrict__ kend, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int H, int D,
                 float scale_log2) {
  fwd_body<DP, MODE>(q, k, v, seg, seg, kstart, kend, o, lse, T, T, H, D,
                     scale_log2);
}

// H9: T (Tq) query rows with ids seg_q over Tk key rows with ids seg_k
template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS)
flash_fwd_rect_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const int* __restrict__ seg_q,
                      const int* __restrict__ seg_k,
                      const int* __restrict__ kstart,
                      const int* __restrict__ kend, bf16* __restrict__ o,
                      float* __restrict__ lse, int Tq, int Tk, int H, int D,
                      float scale_log2) {
  fwd_body<DP, BASELINE>(q, k, v, seg_q, seg_k, kstart, kend, o, lse, Tq, Tk,
                         H, D, scale_log2);
}

template <int DP, int MODE>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg, const int* kstart, const int* kend,
                   void* o, float* lse, int T, int H, int D, float scale,
                   cudaStream_t stream) {
  const size_t smem = Cfg<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H);
  flash_fwd_kernel<DP, MODE><<<grid, Cfg<DP>::NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, kstart, kend, static_cast<bf16*>(o),
      lse, T, H, D, scale * LOG2E);
  return cudaGetLastError();
}

template <int DP>
int launch_rect(const void* q, const void* k, const void* v,
                const int* seg_q, const int* seg_k, const int* kstart,
                const int* kend, void* o, float* lse, int Tq, int Tk, int H,
                int D, float scale, cudaStream_t stream) {
  const size_t smem = Cfg<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_rect_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, H);
  flash_fwd_rect_kernel<DP><<<grid, Cfg<DP>::NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg_q, seg_k, kstart, kend,
      static_cast<bf16*>(o), lse, Tq, Tk, H, D, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
int esme_segment_flash_fwd(const void* q, const void* k, const void* v,
                           const void* seg, const void* kstart,
                           const void* kend, void* o, void* lse, int T,
                           int H, int D, float scale, void* stream) {
  const int* s = static_cast<const int*>(seg);
  const int* ks = static_cast<const int*>(kstart);
  const int* ke = static_cast<const int*>(kend);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16, BASELINE>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
    case 24:
    case 32: return launch<32, BASELINE>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
    case 64: return launch<64, BASELINE>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
    case 128:
      return launch<128, BASELINE>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// H9: H1 with per-side ids and lengths, q and o (Tq, H*D), k and v (Tk,
// H*D), lse (H, Tq). Returns the cudaError_t of the launch (0 on success).
int esme_segment_flash_fwd_rect(const void* q, const void* k, const void* v,
                                const void* seg_q, const void* seg_k,
                                const void* kstart, const void* kend,
                                void* o, void* lse, int Tq, int Tk, int H,
                                int D, float scale, void* stream) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  const int* ks = static_cast<const int*>(kstart);
  const int* ke = static_cast<const int*>(kend);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_rect<16>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H, D,
                             scale, st);
    case 24:
    case 32:
      return launch_rect<32>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H, D,
                             scale, st);
    case 64:
      return launch_rect<64>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H, D,
                             scale, st);
    case 128:
      return launch_rect<128>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H, D,
                              scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// H1 in ablation mode `mode` (enum Mode), D = 64 only. Returns the
// cudaError_t of the launch (0 on success).
int esme_segment_flash_fwd_variant(int mode, const void* q, const void* k,
                                   const void* v, const void* seg,
                                   const void* kstart, const void* kend,
                                   void* o, void* lse, int T, int H, int D,
                                   float scale, void* stream) {
  const int* s = static_cast<const int*>(seg);
  const int* ks = static_cast<const int*>(kstart);
  const int* ke = static_cast<const int*>(kend);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64) return (int)cudaErrorInvalidValue;
#define ESME_FWD_MODE(M) \
  case M: return launch<64, M>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
  switch (mode) {
    ESME_FWD_MODE(BASELINE)
    ESME_FWD_MODE(NOALPHA)
    ESME_FWD_MODE(MAXFREE)
    ESME_FWD_MODE(SUMFREE)
    ESME_FWD_MODE(NOMAX)
    ESME_FWD_MODE(NOMASK)
    ESME_FWD_MODE(NOEXP)
    ESME_FWD_MODE(BF16EXP)
    ESME_FWD_MODE(NOPV)
    ESME_FWD_MODE(NOQK)
    ESME_FWD_MODE(NOTHING)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ESME_FWD_MODE
}

const char* esme_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
