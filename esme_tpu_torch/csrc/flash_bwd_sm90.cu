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
// Head dims 16, 24, 32, 64 and 128; 16 and 24 (ESM2-8M and -35M) on D =
// 32's tiles (sm90_common.cuh: Geo): 32-column boxes, the products over d
// (S and dP) in one k-step at D = 16 and two at D = 24, where each
// consumer warpgroup zeros columns 24-31 of its 64 rows of the resident
// tiles once after their load (K and V in the dk/dv pass, Q and dO in the
// dq pass), so the streamed tiles' extra columns (the next head's) add
// nothing; the extra columns of dV, dK and dQ are never stored.
//
// Two deterministic passes, no atomics, no band buffer (so remat='full'
// stays bit-equal):
// - dk/dv: one CTA per (128-row k block, head), two consumer warpgroups
//   of 64 k rows each. K and V of the block come in once by TMA. The
//   block's q rows (the union of its two 64-row blocks' spans [qstart,
//   qend) of 64-row tiles) stream through a ring of stages<D>() stages of
//   QT = dkv_qt<D>() rows: per stage a q tile and its do tile by TMA, and
//   the stage's segment ids, lse and delta by cp.async, all landing on
//   the stage's "full" mbarrier; consumers hand the stage back on its
//   "empty" mbarrier. Per stage and warpgroup: S^T = K Q^T and dP^T = V
//   dO^T (wgmma, both operands from shared memory, K-major), P^T and dS^T
//   in registers, then dV += P^T dO and dK += dS^T Q (wgmma, A = P^T and
//   dS^T straight from the accumulator registers, B = dO and Q MN-major,
//   the transposed descriptor). At D = 64 a stage is 128 q rows (the
//   union rounded out to 128-row stages; ops/flash.py:dkv_stages mirrors
//   the walk): N = 128 products, 8 k-steps for dV and dK; the CTA is the
//   two consumer warpgroups (240 registers a thread), the first consumer
//   warp issuing the loads at the top of each step; a warpgroup skips the
//   products of a stage outside its own 64-row block's span (p is 0
//   there); and each warpgroup writes dK and dV into its own rows of K
//   and V, dead once its last products are waited, and stores them by
//   TMA. At D = 16-32 a stage is a 64-row tile and a producer warp loads
//   (a 384-thread CTA); at D = 128 64-row tiles in the 256-thread CTA
//   (dkv_threads).
// - dq: one CTA per (128-row q block, head), two consumer warpgroups of
//   64 q rows over the k tiles [kstart, kend) (H1's spans); per tile
//   S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K (K MN-major). At
//   D = 64 there is no producer warp either: the first consumer warp
//   loads, and two CTAs share an SM (dq_ctas).
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
// next products still run in series; the SM's other warpgroups fill the
// gaps: one more in the dk/dv pass, three more in the dq pass at D = 64,
// whose two CTAs per SM took 0.78x the time of one 384-thread CTA on the
// H100 (PERF.md has the times). Keeping two tiles in flight per
// warpgroup (the scores of tile j + 1 under the products of tile j) was
// slower in every form measured there: the dk/dv pass in a 256-thread
// CTA (210 registers, no room for a producer warp) 1.15x, where that CTA
// with the serial chain took 1.13x; with its producer warp and P^T, dS^T
// through shared memory 1.27x; the dq pass at one CTA per SM (140
// registers) 1.24x. At D = 64 the 128-row stages halve the stages a
// dk/dv CTA walks (7.3 against 13.6 on the 50k train batch) and with them
// the votes and waits per key; a timeline of the pass (the TIMELINE mode)
// put 9% of a CTA in the stores of the 64-row form and 14% in waits on
// full stages in the 128-row one, whose loads a consumer warp issues. In
// sm90_ab's turns on the H100 (PERF.md) the 64-row form took 1.078x the
// kept form's time on H2's dk/dv pass and 1.043x on H10's four ranks; the
// forms that lost: 128-row stages alone 1.04x the 64-row form, with the
// skip 1.01x; the skip and the TMA store in the 64-row form 1.074x the
// kept form, the TMA store alone there 1.022x; four stages 1.000x; the
// stage's ids, lse and delta by one lane's bulk copies 1.011x. At D = 128
// (ESM2-15B) the
// same chain bounds the dk/dv pass once its registers fit: its 256-thread
// CTA gives a thread the 228 registers its accumulators and scores take,
// where 384 threads capped them at 168 and the pass kept half of dK and
// dV in local memory, loaded and stored around every tile's products. At
// D = 16 and 24 the exps bound it instead (P recomputed in both passes,
// two per pair), as in H1.
//
// Ablation modes ("H7"): each pass's MODE parameter removes one part of
// the work, as tools/decompose_bwd.py:66 dq_variant and :125 dkv_variant
// (K15) do on the TPU, to measure what each costs; their outputs are wrong
// on purpose. Mode 0 is the production pass, and the only one
// esme_segment_flash_bwd_sm90 launches; esme_flash_bwd_sm90_pass
// launches one pass in mode 0 at any D, or in any mode at D = 64. A
// dropped product is removed at compile time (no guarded wgmma). A
// warpgroup's 64 rows face the stage's 64-row tiles in turn, so dma and
// no_acc pair its row p with each tile's row or column p; the dk/dv pass
// walks its production form's stages in every mode, and the modes that
// keep the mask skip the stages outside a warpgroup's span as it does.
// TIMELINE is the production dk/dv pass at D = 64 with clock stamps of
// where each CTA's time goes (tl_words), in either form (QT = 128, or
// the 64-row form with a producer warp that ran before it); it runs in a
// kernel of its own (bwd_dkv_timeline_sm90_kernel), launched by
// esme_flash_bwd_sm90_timeline.
//
// H10, the rectangular form (bwd_dkv_rect_sm90_kernel and
// bwd_dq_rect_sm90_kernel, the two bodies at D = 16-128 in mode 0, in
// kernels of their own): H2 with queries and keys of their own, Tq query
// rows with ids seg_q over Tk key rows with ids seg_k (context-parallel
// training: a rank's queries over the keys gathered from every rank).
// Replaces the backward of the TPU kernel K-rect, esme_tpu/ops/flash.py:1083
// _flash_bwd_vjp -> _bwd (K4's :_dq_kernel and :_dkv_kernel with
// segq_row != segk_col). Every length in the bodies is one side's: the q
// ring, q's and do's tensor maps, lse, delta and the q ids over Tq; the
// k and v maps, the k ids, the dk/dv grid and its stores over Tk; the dq
// grid and its stores over Tq. H2's kernels pass their one seg and T for
// both sides, so their instantiations compile as they did. Where H10's dq
// pass walks H2's span (a rank whose first row starts a q block), its dq
// rows are H2's bit for bit; its dk and dv hold this rank's queries' share
// of the keys' gradients, which the caller sums over the ranks. Packed
// ids are monotonic, so a rank's queries touch one contiguous range of
// k blocks; a 128-row k CTA outside it (about 3/4 of the grid with 4
// ranks) writes its rows of dk and dv as zeros and leaves before any
// barrier or load, in the kernel and not in the shared body, whose
// arithmetic stays H2's. The work and what bounds it are H2's over the
// rank's same-segment pairs, plus the zero rows' stores.

#include <limits.h>

#include "sm90_common.cuh"

namespace {

using namespace esme;
using namespace esme::sm90;

constexpr int BKV = 128;  // dk/dv: k rows per CTA (two warpgroups)
constexpr int BQ = 128;   // dq: q rows per CTA (two warpgroups)
constexpr int KT = 64;    // dq: k tile rows

template <int D>
__host__ __device__ constexpr int stages() { return D > 64 ? 2 : 3; }

// The dk/dv pass's q rows a stage (QT): 128 at D = 64, 64 at the other
// head dims. A 128-row stage halves the stages a CTA walks, and with them
// the full-barrier waits, the votes and the product waits per key; its
// S^T and dP^T are N = 128 products and dV and dK take 8 k-steps over the
// stage's rows, in the order two 64-row tiles would give them, so the
// sums keep their bits. The walk is the 64-row spans' union rounded out
// to 128-row stages (ops/flash.py:dkv_stages); a 64-row half the
// rounding adds lies outside the block's segments and adds exact zeros.
template <int D>
__host__ __device__ constexpr int dkv_qt() { return D == 64 ? 128 : 64; }

// The dk/dv pass's threads. At D = 128 a consumer thread holds dK and dV
// (64 fp32 each), S^T and dP^T (32 each) and their bf16 fragments: 228
// registers as ptxas allocates them. At D = 64 with 128-row stages it
// holds dK and dV (32 each) and S^T and dP^T (64 each): the same 192
// before any fragment. A 384-thread CTA puts three of its twelve warps
// on one of the SM's four register files, which caps every thread at
// 168: ptxas spilled the D = 128 pass there, and setmaxnreg (the
// producer warpgroup's registers handed to the consumers) left its
// allocation as it was. So there the CTA is the two consumer warpgroups
// alone, two warps on each register file and up to 255 registers a
// thread, and the first consumer warp also loads, as H1's warp 0 does.
// The 64-row form at D <= 64 keeps its producer warp (QT = 64).
template <int D, int QT>
__host__ __device__ constexpr bool warp0_loads() {
  return D == 128 || QT == 128;
}
template <int D, int QT>
__host__ __device__ constexpr int dkv_threads() {
  return warp0_loads<D, QT>() ? 2 * 128 : 3 * 128;
}

// The dq pass's threads and CTAs per SM. At D = 64 a consumer thread
// needs 122 registers, so a CTA of the two consumer warpgroups alone (the
// first consumer warp loads, as in the dk/dv pass at D = 128) lets two
// CTAs share an SM: four warpgroups whose chains of products and scores
// fill each other's gaps, where the 384-thread CTA's 123 registers left
// room for one (its producer warp's registers count too).
template <int D>
__host__ __device__ constexpr bool dq_warp0_loads() { return D == 64; }
template <int D>
__host__ __device__ constexpr int dq_threads() {
  return dq_warp0_loads<D>() ? 2 * 128 : 3 * 128;
}
template <int D>
__host__ __device__ constexpr int dq_ctas() {
  return dq_warp0_loads<D>() ? 2 : 1;
}

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
  // not an ablation: the production dk/dv pass at D = 64, clock stamps of
  // where each CTA's time goes written beside it (dkv_timeline)
  TIMELINE,
};

// The modes that keep the segment mask (skipped on one-segment tiles)
template <int MODE>
__host__ __device__ constexpr bool masks() {
  return MODE == REAL || MODE == NO_S || MODE == NO_DP || MODE == NO_ACC ||
         MODE == TIMELINE;
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

template <int D, int MODE, int QT>
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

// The timeline's record of one CTA (mode TIMELINE), in 64-bit words, for
// a launch whose CTAs walk at most S stages:
//   0: %smid; 1: the stages the CTA walks; 2, 3: %globaltimer (ns) at its
//      entry and after its stores (thread 0);
//   4 + 3 w + {0, 1, 2}: consumer warpgroup w's clock64 at its entry, once
//      K and V have landed, after its stores;
//   10 + i: stage i's loads issued (the loading warp's lane 0);
//   10 + S + 5 (w S + i) + {0, ..., 4}: warpgroup w at stage i: its full
//      barrier passed, S^T and dP^T waited, the scores done, dV and dK
//      waited, the stage handed back.
// A warpgroup's stamps are its first thread's. A CTA that leaves before
// any barrier (an empty span in H10) writes words 0 and 1 alone.
__host__ __device__ constexpr int tl_words(int S) { return 10 + 11 * S; }

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned smid() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(id));
  return id;
}

// S^T or dP^T of one stage: d (64 x QT fp32) = A B, A the warpgroup's 64
// k rows and B the stage's QT q rows, both K-major
template <int QT>
__device__ __forceinline__ void wgmma_ss_qt(float (&d)[QT / 2], uint64_t a,
                                            uint64_t b, int accumulate) {
  if constexpr (QT == 128) wgmma_ss_n128(d, a, b, accumulate);
  else wgmma_ss_n64(d, a, b, accumulate);
}

// P^T and dS^T of one stage in place of S^T and dP^T: this thread's k rows
// r (sk[r]) against the stage's q columns c = 8 j + 2 tq + e
template <int MODE, bool MASK, int QT>
__device__ __forceinline__ void dkv_scores(float (&s)[QT / 2],
                                           float (&dp)[QT / 2],
                                           const int* sq, const float* lse,
                                           const float* delta,
                                           const int (&sk)[2], int tq,
                                           float scale, float scale_log2) {
#pragma unroll
  for (int j = 0; j < QT / 8; ++j) {
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

// The q tiles of a dk/dv CTA's two 64-row k blocks, as one span of 64-row
// tiles: the union of theirs (a last odd block alone keeps its own)
__device__ __forceinline__ int2 dkv_union_span(const int* __restrict__ qstart,
                                              const int* __restrict__ qend,
                                              int kb, int Tk) {
  int qb0 = qstart[2 * kb], qb1 = qend[2 * kb];
  if (2 * kb + 1 < (Tk + 63) / 64) {
    qb0 = min(qb0, qstart[2 * kb + 1]);
    qb1 = max(qb1, qend[2 * kb + 1]);
  }
  return make_int2(qb0, qb1);
}

// The dk/dv pass's body, shared by H2 (and H7) and H10: the queries have
// ids seg over T rows and the keys ids segk over Tk rows; H2's kernel
// passes its one seg and T for both, H10's kernel the two sides' own. A
// CTA walks its union span in stages of QT rows (dkv_qt). TIMELINE writes
// the CTA's record (tl_words) into tl, whose records hold tl_stages
// stages.
template <int D, int MODE, int QT = dkv_qt<D>()>
__device__ __forceinline__ void dkv_body(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_do, const CUtensorMap& tm_dk,
    const CUtensorMap& tm_dv, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    const int* __restrict__ segk, const int* __restrict__ qstart,
    const int* __restrict__ qend, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int T, int Tk, int H, float scale,
    float scale_log2, unsigned long long* __restrict__ tl = nullptr,
    int tl_stages = 0) {
  using G = Geo<D>;
  using L = DkvSmem<D, MODE, QT>;
  constexpr int ST = L::ST;
  constexpr int R = QT / 64;   // 64-row tiles a stage
  // The 128-row form (D = 64) also skips, per warpgroup, the stages
  // outside its own 64-row k block's span, and stores dK and dV by TMA
  constexpr bool FORM128 = QT == 128;
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
  const int wg = threadIdx.x / 128;
  // the union span, rounded out to stages of QT rows
  const int2 span = dkv_union_span(qstart, qend, kb, Tk);
  const int sb0 = span.x / R;
  const int n = span.y > span.x ? (span.y + R - 1) / R - sb0 : 0;

  unsigned long long* rec = nullptr;
  if constexpr (MODE == TIMELINE) {
    rec = tl + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) *
                   tl_words(tl_stages);
    if (threadIdx.x % 128 == 0 && wg < 2) rec[4 + 3 * wg] = clock64();
    if (threadIdx.x == 0) {
      rec[0] = smid();
      rec[1] = n;
      rec[2] = globaltimer();
    }
  }
  // stamp k of stage i (TIMELINE), by the warpgroup's first thread
  auto stamp = [&](int i, int k) {
    if constexpr (MODE == TIMELINE)
      if (threadIdx.x % 128 == 0 && i < tl_stages)
        rec[10 + tl_stages + 5 * (wg * tl_stages + i) + k] = clock64();
  };
  auto stamp_issue = [&](int i) {
    if constexpr (MODE == TIMELINE)
      if (i < tl_stages) rec[10 + i] = clock64();
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);   // expect_tx + 32 lanes' cp.async
      mbar_init(&empty[s], 8);       // one per consumer warp
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // The first consumer warp's loads in a 256-thread CTA (warp0_loads): K
  // and V of the block, then stage j (q, do, the stage's ids, lse and
  // delta) into slot j % ST once the slot's last round is handed back.
  // The producer warp below keeps its own copy of these steps: run
  // through these lambdas, its D = 64 pass took 3% longer on the H100.
  auto load_kv = [&]() {
    mbar_expect_tx(kv_bar, 2 * L::KV_TILE);
    tma_tile<D, BKV>(smem + L::K, &tm_k, kv_bar, col0, k0);
    tma_tile<D, BKV>(smem + L::V, &tm_v, kv_bar, col0, k0);
  };
  auto load_q = [&](int j, int lane) {
    const int s = j % ST;
    mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
    const int q0 = (sb0 + j) * QT;
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * L::Q_TILE);
      tma_tile<D, QT>(q_tile(s), &tm_q, &full[s], col0, q0);
      tma_tile<D, QT>(do_tile(s), &tm_do, &full[s], col0, q0);
      stamp_issue(j);
    }
    float* w = words(s);
#pragma unroll
    for (int i = lane; i < QT; i += 32) {
      const int t = q0 + i;
      const bool ok = t < T;
      const int ts = ok ? t : 0;
      cp_async4(smem_u32(w + i), seg + ts, ok);
      cp_async4(smem_u32(w + QT + i), lse + (size_t)h * T + ts, ok);
      cp_async4(smem_u32(w + 2 * QT + i), delta + (size_t)h * T + ts, ok);
    }
    mbar_arrive_cp_async(&full[s]);
  };

  if (!warp0_loads<D, QT>() && wg == 2) {
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
      const int q0 = (sb0 + it) * QT;
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::Q_TILE);
        tma_tile<D, QT>(q_tile(s), &tm_q, &full[s], col0, q0);
        tma_tile<D, QT>(do_tile(s), &tm_do, &full[s], col0, q0);
        stamp_issue(it);
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
      sk[r] = krow[r] < Tk ? segk[krow[r]] : INT_MIN;
    }
    // one segment over the warp's 16 k rows?
    const int kid = lane < 16 && k0 + row0 + lane < Tk
                        ? segk[k0 + row0 + lane]
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
    const bool loader = warp0_loads<D, QT>() && threadIdx.x < 32;
    // the warpgroup's own 64-row k block's span of 64-row q tiles
    const int kb64 = 2 * kb + wg;
    const bool has = kb64 < (Tk + 63) / 64;
    const int own0 = has ? qstart[kb64] : 0, own1 = has ? qend[kb64] : 0;
    if (loader) {
      if (lane == 0) load_kv();
      for (int j = 0; j < ST - 1 && j < n; ++j) load_q(j, lane);
    }
    mbar_wait(kv_bar, 0);
    if constexpr (MODE == TIMELINE)
      if (threadIdx.x % 128 == 0) rec[5 + 3 * wg] = clock64();
    if constexpr (G::PAD) {
      // the warpgroup's 64 rows of K (threads 0-63) and of V (64-127):
      // columns past D to 0
      const int t = threadIdx.x % 128;
      zero_pad<D, BKV>(smem + (t < 64 ? L::K : L::V), wg * 64 + t % 64);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
    }
    for (int it = 0; it < n; ++it) {
      if (loader && it + ST - 1 < n) load_q(it + ST - 1, lane);
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      stamp(it, 0);
      if constexpr (FORM128 && masks<MODE>()) {
        // a stage outside the warpgroup's own span: p = 0 throughout
        const int t0 = (sb0 + it) * R;
        if (t0 >= own1 || t0 + R <= own0) {
          stamp(it, 1);
          stamp(it, 2);
          stamp(it, 3);
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[s]);
          stamp(it, 4);
          continue;
        }
      }
      const uint32_t qs = smem_u32(q_tile(s));
      const uint32_t ds = smem_u32(do_tile(s));
      const float* w = words(s);
      const int* sq = reinterpret_cast<const int*>(w);
      bool one = kuni;
#pragma unroll
      for (int c = 0; c < QT / 32; ++c) one = one && sq[lane + 32 * c] == kref;
      const bool uni = masks<MODE>() && __all_sync(0xffffffffu, one);

      if constexpr (MODE == DMA) {
        // every element of the four tiles, the stage's q rows p and p + 64
        // in turn facing k row p of the warpgroup's half, into dk; the q
        // rows' lse and delta into dv
#pragma unroll
        for (int hq = 0; hq < R; ++hq)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int p = warp * 16 + r * 8 + g;
            const int pq = hq * 64 + p;
            const float lp = w[QT + pq], dlp = w[2 * QT + pq];
#pragma unroll
            for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
              for (int j = 0; j < G::HALF_COLS / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int c = nh * G::HALF_COLS + 8 * j + 2 * tq + e;
                  const int i = 4 * j + 2 * r + e;
                  const int qo = tile_offset<D, QT>(pq, c);
                  const int ko = tile_offset<D, BKV>(wg * 64 + p, c);
                  dka[nh][i] += ((smem_bf16(q_tile(s), qo) +
                                  smem_bf16(do_tile(s), qo)) +
                                 smem_bf16(smem + L::K, ko)) +
                                smem_bf16(smem + L::V, ko);
                  dva[nh][i] = (dva[nh][i] + lp) + dlp;
                }
          }
      } else {
        float st[QT / 2], dpt[QT / 2];
#pragma unroll
        for (int i = 0; i < QT / 2; ++i) {   // the product a mode drops reads 0
          if constexpr (MODE == NO_S) st[i] = 0.f;
          if constexpr (MODE == NO_DP) dpt[i] = 0.f;
        }
        wgmma_fence();
        if constexpr (MODE != NO_S) {
#pragma unroll
          for (int kk = 0; kk < G::KSTEPS; ++kk)
            wgmma_ss_qt<QT>(st, desc_k<D, BKV>(ks, wg * 64, kk),
                            desc_k<D, QT>(qs, 0, kk), kk > 0);
        }
        if constexpr (MODE != NO_DP) {
#pragma unroll
          for (int kk = 0; kk < G::KSTEPS; ++kk)
            wgmma_ss_qt<QT>(dpt, desc_k<D, BKV>(vs, wg * 64, kk),
                            desc_k<D, QT>(ds, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (MODE != NO_S) fence_regs(st);
        if constexpr (MODE != NO_DP) fence_regs(dpt);
        stamp(it, 1);

        if (uni || !masks<MODE>())
          dkv_scores<MODE, false, QT>(st, dpt, sq, w + QT, w + 2 * QT, sk,
                                      tq, scale, scale_log2);
        else
          dkv_scores<MODE, true, QT>(st, dpt, sq, w + QT, w + 2 * QT, sk, tq,
                                     scale, scale_log2);
        stamp(it, 2);

        if constexpr (MODE == NO_ACC) {
          // dk row p gains the max over the warpgroup's 64 k rows of dS^T's
          // q columns p and p + 64 in turn: over the lane's two rows and
          // the 8 lanes of its column, then the warpgroup's four warps
          // through shared memory
          float* colmax = reinterpret_cast<float*>(smem + L::COLMAX) +
                          ((it & 1) * 8 + wg * 4) * QT;
#pragma unroll
          for (int j = 0; j < QT / 8; ++j)
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
          for (int hq = 0; hq < R; ++hq)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int p = hq * 64 + warp * 16 + r * 8 + g;
              float mx = colmax[p];
#pragma unroll
              for (int w4 = 1; w4 < 4; ++w4)
                mx = fmaxf(mx, colmax[w4 * QT + p]);
#pragma unroll
              for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
                for (int j = 0; j < G::HALF_COLS / 8; ++j) {
                  dka[nh][4 * j + 2 * r] += mx;
                  dka[nh][4 * j + 2 * r + 1] += mx;
                }
            }
        } else {
          uint32_t pa[QT / 16][4], sa[QT / 16][4];
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk) {
            acc_to_a(pa[kk], st, kk);
            acc_to_a(sa[kk], dpt, kk);
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk)
#pragma unroll
            for (int nh = 0; nh < G::NH; ++nh)
              wgmma_rs(dva[nh], pa[kk], desc_mn<D, QT>(ds, kk, nh));
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk)
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
        stamp(it, 3);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      stamp(it, 4);
    }

    if constexpr (FORM128) {
      // the warpgroup's own 64 rows of K and V, which only its products
      // read (all waited), take dK and dV in the tiles' layout; one
      // thread stores them by TMA (rows past Tk are not written)
      unsigned char* kt = smem + L::K + wg * 64 * G::RB;
      unsigned char* vt = smem + L::V + wg * 64 * G::RB;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < G::OWN_COLS / 8; ++j) {
          const int off = tile_offset<D, 64>(warp * 16 + r * 8 + g,
                                             8 * j + 2 * tq);
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<uint32_t*>(kt + off) =
              pack_bf16(dka[0][i], dka[0][i + 1]);
          *reinterpret_cast<uint32_t*>(vt + off) =
              pack_bf16(dva[0][i], dva[0][i + 1]);
        }
      fence_proxy_async();
      named_barrier(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
        tma_store_2d(&tm_dk, kt, col0, k0 + wg * 64);
        tma_store_2d(&tm_dv, vt, col0, k0 + wg * 64);
        tma_store_wait();
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (krow[r] >= Tk) continue;
        bf16* dkrow = dk + (size_t)krow[r] * HD + col0;
        bf16* dvrow = dv + (size_t)krow[r] * HD + col0;
#pragma unroll
        for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
          for (int j = 0; j < G::OWN_COLS / 8; ++j) {
            const int c = nh * G::HALF_COLS + 8 * j + 2 * tq;
            const int i = 4 * j + 2 * r;
            *reinterpret_cast<__nv_bfloat162*>(dkrow + c) =
                __floats2bfloat162_rn(dka[nh][i], dka[nh][i + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dvrow + c) =
                __floats2bfloat162_rn(dva[nh][i], dva[nh][i + 1]);
          }
      }
    }
    if constexpr (MODE == TIMELINE) {
      if (threadIdx.x % 128 == 0) rec[6 + 3 * wg] = clock64();
      if (threadIdx.x == 0) rec[3] = globaltimer();
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(dkv_threads<D, dkv_qt<D>()>(), 1)
bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dk,
                    const __grid_constant__ CUtensorMap tm_dv,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg,
                    const int* __restrict__ qstart,
                    const int* __restrict__ qend, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int T, int H, float scale,
                    float scale_log2) {
  dkv_body<D, MODE>(tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, lse, delta, seg,
                    seg, qstart, qend, dk, dv, T, T, H, scale, scale_log2);
}

// H10's dk/dv CTA whose k rows no query shares an id with (an empty
// span): its rows of dk and dv written as zeros. Returns whether the CTA
// is such a one, which then leaves before any barrier or load.
template <int D>
__device__ __forceinline__ bool dkv_empty_cta(const int* __restrict__ qstart,
                                              const int* __restrict__ qend,
                                              bf16* __restrict__ dk,
                                              bf16* __restrict__ dv, int Tk,
                                              int H) {
  const int kb = blockIdx.x;
  const int2 span = dkv_union_span(qstart, qend, kb, Tk);
  if (span.y > span.x) return false;
  const int HD = H * D;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < BKV * D / 8; i += blockDim.x) {
    const int t = kb * BKV + i / (D / 8);
    if (t >= Tk) break;
    const size_t off = (size_t)t * HD + blockIdx.y * D + i % (D / 8) * 8;
    *reinterpret_cast<uint4*>(dk + off) = zero;
    *reinterpret_cast<uint4*>(dv + off) = zero;
  }
  return true;
}

// H10's dk/dv pass: Tq query rows with ids seg_q over Tk key rows with ids
// seg_k. A CTA whose k rows no query shares an id with (an empty span)
// writes its zero rows of dk and dv and leaves, before any barrier or
// load.
template <int D>
__global__ void __launch_bounds__(dkv_threads<D, dkv_qt<D>()>(), 1)
bwd_dkv_rect_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dk,
                         const __grid_constant__ CUtensorMap tm_dv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k,
                         const int* __restrict__ qstart,
                         const int* __restrict__ qend, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Tq, int Tk, int H,
                         float scale, float scale_log2) {
  if (dkv_empty_cta<D>(qstart, qend, dk, dv, Tk, H)) return;
  dkv_body<D, REAL>(tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, lse, delta, seg_q,
                    seg_k, qstart, qend, dk, dv, Tq, Tk, H, scale,
                    scale_log2);
}

// The dk/dv pass with its timeline (mode TIMELINE): H10's kernel (H2's
// when both sides' ids and lengths are the same) in the form of QT-row
// stages, 128 the production form at D = 64 and 64 the 384-thread form
// with a producer warp that ran before it. An empty CTA records that it
// walks no stage.
template <int D, int QT>
__global__ void __launch_bounds__(dkv_threads<D, QT>(), 1)
bwd_dkv_timeline_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_dk,
    const __grid_constant__ CUtensorMap tm_dv, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg_q,
    const int* __restrict__ seg_k, const int* __restrict__ qstart,
    const int* __restrict__ qend, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Tq, int Tk, int H, float scale,
    float scale_log2, unsigned long long* __restrict__ tl, int tl_stages) {
  if (dkv_empty_cta<D>(qstart, qend, dk, dv, Tk, H)) {
    if (threadIdx.x == 0) {
      unsigned long long* rec =
          tl + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) *
                   tl_words(tl_stages);
      rec[0] = smid();
      rec[1] = 0;
    }
    return;
  }
  dkv_body<D, TIMELINE, QT>(tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, lse, delta,
                            seg_q, seg_k, qstart, qend, dk, dv, Tq, Tk, H,
                            scale, scale_log2, tl, tl_stages);
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

// The dq pass's body, shared by H2 (and H7) and H10, with the two sides'
// ids and lengths as in dkv_body
template <int D, int MODE>
__device__ __forceinline__ void dq_body(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ seg,
    const int* __restrict__ segk, const int* __restrict__ kstart,
    const int* __restrict__ kend, bf16* __restrict__ dq, int T, int Tk, int H,
    float scale, float scale_log2) {
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

  // The first consumer warp's loads at D = 64 (dq_warp0_loads): Q and dO of
  // the block, then k tile j (k, v, the tile's ids) into stage j % ST once
  // the stage's last round is handed back. The producer warp below keeps
  // its own copy of these steps, as in dkv_body.
  auto load_qdo = [&]() {
    mbar_expect_tx(qdo_bar, 2 * L::Q_TILE);
    tma_tile<D, BQ>(smem + L::Q, &tm_q, qdo_bar, col0, q0);
    tma_tile<D, BQ>(smem + L::DO, &tm_do, qdo_bar, col0, q0);
  };
  auto load_k = [&](int j, int lane) {
    const int s = j % ST;
    mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
    const int k0 = (kb0 + j) * KT;
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * L::K_TILE);
      tma_tile<D, KT>(k_tile(s), &tm_k, &full[s], col0, k0);
      tma_tile<D, KT>(v_tile(s), &tm_v, &full[s], col0, k0);
    }
#pragma unroll
    for (int i = lane; i < KT; i += 32) {
      const int t = k0 + i;
      cp_async4(smem_u32(ids(s) + i), segk + (t < Tk ? t : 0), t < Tk);
    }
    mbar_arrive_cp_async(&full[s]);
  };

  const int wg = threadIdx.x / 128;
  if (!dq_warp0_loads<D>() && wg == 2) {
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
        cp_async4(smem_u32(ids(s) + i), segk + (t < Tk ? t : 0), t < Tk);
      }
      mbar_arrive_cp_async(&full[s]);
    }
  } else {
    const int warp = (threadIdx.x % 128) >> 5;
    const int lane = threadIdx.x & 31;
    const bool loader = dq_warp0_loads<D>() && threadIdx.x < 32;
    if (loader) {
      if (lane == 0) load_qdo();
      for (int j = 0; j < ST - 1 && j < n; ++j) load_k(j, lane);
    }
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
    if constexpr (G::PAD) {
      // the warpgroup's 64 rows of Q (threads 0-63) and of dO (64-127):
      // columns past D to 0
      const int t = threadIdx.x % 128;
      zero_pad<D, BQ>(smem + (t < 64 ? L::Q : L::DO), wg * 64 + t % 64);
      fence_proxy_async();
      named_barrier(1 + wg, 128);
    }
    for (int it = 0; it < n; ++it) {
      if (loader && it + ST - 1 < n) load_k(it + ST - 1, lane);
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const uint32_t ks = smem_u32(k_tile(s));
      const uint32_t vs = smem_u32(v_tile(s));
      const int* skt = ids(s);
      const int kn = Tk - (kb0 + it) * KT;   // the tile's k rows that exist
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
          for (int kk = 0; kk < G::KSTEPS; ++kk)
            wgmma_ss_n64(sc, desc_k<D, BQ>(qs, wg * 64, kk),
                         desc_k<D, KT>(ks, 0, kk), kk > 0);
        }
        if constexpr (MODE != NO_DP) {
#pragma unroll
          for (int kk = 0; kk < G::KSTEPS; ++kk)
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
        for (int j = 0; j < G::OWN_COLS / 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(out + nh * G::HALF_COLS + 8 * j +
                                             2 * tq) =
              __floats2bfloat162_rn(acc[nh][i], acc[nh][i + 1]);
        }
    }
  }
}

template <int D, int MODE>
__global__ void __launch_bounds__(dq_threads<D>(), dq_ctas<D>())
bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seg, const int* __restrict__ kstart,
                   const int* __restrict__ kend, bf16* __restrict__ dq, int T,
                   int H, float scale, float scale_log2) {
  dq_body<D, MODE>(tm_q, tm_k, tm_v, tm_do, lse, delta, seg, seg, kstart, kend,
                   dq, T, T, H, scale, scale_log2);
}

// H10's dq pass: Tq query rows with ids seg_q over Tk key rows with ids
// seg_k
template <int D>
__global__ void __launch_bounds__(dq_threads<D>(), dq_ctas<D>())
bwd_dq_rect_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int* __restrict__ seg_q,
                        const int* __restrict__ seg_k,
                        const int* __restrict__ kstart,
                        const int* __restrict__ kend, bf16* __restrict__ dq,
                        int Tq, int Tk, int H, float scale, float scale_log2) {
  dq_body<D, REAL>(tm_q, tm_k, tm_v, tm_do, lse, delta, seg_q, seg_k, kstart,
                   kend, dq, Tq, Tk, H, scale, scale_log2);
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
  // the keys' own ids and length (H10); H2's are seg and T
  const int* segk;
  int Tk;
};

// One pass of H2 (RECT false, in mode MODE) or of H10 (RECT true, mode
// 0), in stages of QT rows; mode TIMELINE: H10's kernel with its timeline
// (tl, tl_stages). The q and do maps have a.T rows, the k and v maps a.Tk.
template <int D, int MODE, bool RECT = false, int QT = dkv_qt<D>()>
cudaError_t launch_dkv(const Args& a, unsigned long long* tl = nullptr,
                       int tl_stages = 0) {
  using L = DkvSmem<D, MODE, QT>;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  const int HD = a.H * D;
  cudaError_t err;
  if ((err = tile_map<D>(&tq, a.q, a.T, HD, QT)) != cudaSuccess ||
      (err = tile_map<D>(&tdo, a.dout, a.T, HD, QT)) != cudaSuccess ||
      (err = tile_map<D>(&tk, a.k, a.Tk, HD, BKV)) != cudaSuccess ||
      (err = tile_map<D>(&tv, a.v, a.Tk, HD, BKV)) != cudaSuccess ||
      (err = tile_map<D>(&tdk, a.dk, a.Tk, HD, 64)) != cudaSuccess ||
      (err = tile_map<D>(&tdv, a.dv, a.Tk, HD, 64)) != cudaSuccess)
    return err;
  const dim3 grid((a.Tk + BKV - 1) / BKV, a.H);
  constexpr int threads = dkv_threads<D, QT>();
  if constexpr (MODE == TIMELINE) {
    auto kernel = bwd_dkv_timeline_sm90_kernel<D, QT>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, L::BYTES, a.stream>>>(
        tq, tk, tv, tdo, tdk, tdv, a.lse, a.delta, a.seg, a.segk, a.qstart,
        a.qend, a.dk, a.dv, a.T, a.Tk, a.H, a.scale, a.scale * LOG2E, tl,
        tl_stages);
  } else if constexpr (RECT) {
    auto kernel = bwd_dkv_rect_sm90_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, L::BYTES, a.stream>>>(
        tq, tk, tv, tdo, tdk, tdv, a.lse, a.delta, a.seg, a.segk, a.qstart,
        a.qend, a.dk, a.dv, a.T, a.Tk, a.H, a.scale, a.scale * LOG2E);
  } else {
    auto kernel = bwd_dkv_sm90_kernel<D, MODE>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, L::BYTES, a.stream>>>(
        tq, tk, tv, tdo, tdk, tdv, a.lse, a.delta, a.seg, a.qstart, a.qend,
        a.dk, a.dv, a.T, a.H, a.scale, a.scale * LOG2E);
  }
  return cudaGetLastError();
}

template <int D, int MODE, bool RECT = false>
cudaError_t launch_dq(const Args& a) {
  using L = DqSmem<D>;
  CUtensorMap tq, tk, tv, tdo;
  const int HD = a.H * D;
  cudaError_t err;
  if ((err = tile_map<D>(&tq, a.q, a.T, HD, BQ)) != cudaSuccess ||
      (err = tile_map<D>(&tdo, a.dout, a.T, HD, BQ)) != cudaSuccess ||
      (err = tile_map<D>(&tk, a.k, a.Tk, HD, KT)) != cudaSuccess ||
      (err = tile_map<D>(&tv, a.v, a.Tk, HD, KT)) != cudaSuccess)
    return err;
  const dim3 grid((a.T + BQ - 1) / BQ, a.H);
  if constexpr (RECT) {
    auto kernel = bwd_dq_rect_sm90_kernel<D>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, dq_threads<D>(), L::BYTES, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, a.seg, a.segk, a.kstart, a.kend,
        a.dq, a.T, a.Tk, a.H, a.scale, a.scale * LOG2E);
  } else {
    auto kernel = bwd_dq_sm90_kernel<D, MODE>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<grid, dq_threads<D>(), L::BYTES, a.stream>>>(
        tq, tk, tv, tdo, a.lse, a.delta, a.seg, a.kstart, a.kend, a.dq, a.T,
        a.H, a.scale, a.scale * LOG2E);
  }
  return cudaGetLastError();
}

// which = 0: dk/dv; 1: dq
template <int D, int MODE = REAL>
cudaError_t launch_pass(const Args& a, int which) {
  return which == 0 ? launch_dkv<D, MODE>(a) : launch_dq<D, MODE>(a);
}

cudaError_t launch_pass(const Args& a, int D, int which) {
  switch (D) {
    case 16: return launch_pass<16>(a, which);
    case 24: return launch_pass<24>(a, which);
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

// One pass of H10 (which = 0: dk/dv, 1: dq)
template <int D>
cudaError_t launch_rect_pass(const Args& a, int which) {
  return which == 0 ? launch_dkv<D, REAL, true>(a)
                    : launch_dq<D, REAL, true>(a);
}

cudaError_t launch_rect_pass(const Args& a, int D, int which) {
  switch (D) {
    case 16: return launch_rect_pass<16>(a, which);
    case 24: return launch_rect_pass<24>(a, which);
    case 32: return launch_rect_pass<32>(a, which);
    case 64: return launch_rect_pass<64>(a, which);
    case 128: return launch_rect_pass<128>(a, which);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* seg,
               const void* kstart, const void* kend, const void* qstart,
               const void* qend, void* dq, void* dk, void* dv, int T, int H,
               float scale, void* stream, const void* segk = nullptr,
               int Tk = -1) {
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
              static_cast<cudaStream_t>(stream),
              static_cast<const int*>(segk ? segk : seg),
              Tk < 0 ? T : Tk};
}

}  // namespace

extern "C" {

// Both passes, dk/dv then dq. D in {16, 24, 32, 64, 128}. Returns the
// cudaError_t of the launches (0 on success).
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
// order): mode 0, the production pass, at D in {16, 24, 32, 64, 128}, to
// time it; the other modes at D = 64 only. which = 0 writes dk and dv,
// which = 1 writes dq. Returns the cudaError_t of the launch.
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

// H10: H2 with per-side ids and lengths, q, do and dq (Tq, H*D), k, v,
// dk and dv (Tk, H*D), lse and delta (H, Tq); dk/dv then dq. D in {16,
// 24, 32, 64, 128}. Returns the cudaError_t of the launches (0 on success).
int esme_segment_flash_bwd_rect_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* kstart, const void* kend, const void* qstart,
    const void* qend, void* dq, void* dk, void* dv, int Tq, int Tk, int H,
    int D, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, seg_q, kstart, kend,
                           qstart, qend, dq, dk, dv, Tq, H, scale, stream,
                           seg_k, Tk);
  const cudaError_t err = launch_rect_pass(a, D, 0);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_rect_pass(a, D, 1);
}

// One pass of H10 alone, to time it: which = 0 writes dk and dv, which =
// 1 writes dq. The other arguments are esme_segment_flash_bwd_rect_sm90's.
// Returns the cudaError_t of the launch.
int esme_flash_bwd_rect_sm90_pass(
    int which, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* delta, const void* seg_q,
    const void* seg_k, const void* kstart, const void* kend,
    const void* qstart, const void* qend, void* dq, void* dk, void* dv,
    int Tq, int Tk, int H, int D, float scale, void* stream) {
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg_q, kstart, kend,
                           qstart, qend, dq, dk, dv, Tq, H, scale, stream,
                           seg_k, Tk);
  return (int)launch_rect_pass(a, D, which);
}

// The dk/dv pass at D = 64 with its timeline (mode TIMELINE): `form` 128
// runs the production pass's 128-row stages in its 256-thread CTA, 64
// the 64-row stages of the 384-thread CTA with a producer warp that ran
// before it. Arguments as esme_flash_bwd_rect_sm90_pass's (H2: seg_q =
// seg_k, Tq = Tk), kstart, kend and dq left out; `stamps` holds
// tl_words(stages) 64-bit words for each CTA of the (ceil(Tk / 128), H)
// grid, row-major, `stages` at least the most stages a CTA walks in that
// form. Returns the cudaError_t of the launch.
int esme_flash_bwd_sm90_timeline(
    int form, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* seg_k,
    const void* qstart, const void* qend, void* dk, void* dv, void* stamps,
    int Tq, int Tk, int H, int D, float scale, int stages, void* stream) {
  if (D != 64 || stages < 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, seg_q, nullptr, nullptr,
                           qstart, qend, nullptr, dk, dv, Tq, H, scale,
                           stream, seg_k, Tk);
  auto* tl = static_cast<unsigned long long*>(stamps);
  if (form == 128)
    return (int)launch_dkv<64, TIMELINE, true, 128>(a, tl, stages);
  if (form == 64)
    return (int)launch_dkv<64, TIMELINE, true, 64>(a, tl, stages);
  return (int)cudaErrorInvalidValue;
}

const char* esme_flash_bwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
