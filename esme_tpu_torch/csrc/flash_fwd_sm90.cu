// H1: varlen segment-flash attention forward for Hopper (sm_90a), on
// wgmma fed by TMA through an mbarrier ring.
//
// Replaces, as the mma.sync form (flash_fwd.cu) did, the TPU forward
// kernels esme_tpu/ops/flash.py:_fwd_kernel (K1, static k-span sweep),
// :_fwd_jobs_kernel (K2, list of real (q-block, k-tile) jobs) and
// esme_tpu/ops/flash_v2.py:_fwd_kernel_v2 (K6), and the pure relayouts
// around them, esme_tpu/ops/headsplit.py:_split_one_kernel_t (K9, v) and
// :_merge_kernel_t (K10, o): q, k, v are read and o is written in the
// projections' (T, H*D) layout. The function is the mma.sync form's:
// scores q.k scaled by 1/sqrt(D) and masked to -1e30 where the segment
// ids differ, online softmax with m, l and the accumulator in fp32 (base
// 2 on scores pre-multiplied by log2(e)), p rounded to bf16 before the
// product with v, o normalised by l (rows with l == 0 kept finite), lse
// = m + log(l) in base e, fp32, (H, T). Head dims 16, 24, 32, 64 and
// 128; 16 and 24 (ESM2-8M and -35M) on D = 32's tiles (sm90_common.cuh:
// Geo): 32-column boxes, one k-step of S at D = 16 and two at D = 24,
// where warpgroup w zeros columns 24-31 of its 64 rows of Q once after
// the Q load, so the K tiles' extra columns (the next head's) add
// nothing to S; O's extra columns are never stored.
//
// Deterministic, no atomics: each output row is written by one CTA, so
// remat='full' stays bit-equal.
//
// Layout: one CTA per (128-row q block, head) over the block's span of
// flash_spans (BLOCK_Q = 128 over BLOCK_K = 64 k tiles, the span set H2's
// dq pass uses too), two warpgroups of 64 q rows each. The span's 64-row
// k tiles are taken in pairs: one ring stage holds 128 k rows (an odd
// span's last stage reads the tile after the span, whose ids belong to no
// q row of the block, so it masks itself). Warp 0 also loads: the block's
// Q once by TMA, then stage j + stages - 1 at the top of step j, once the
// stage's previous round is handed back on its "empty" mbarrier: the K
// and V rows by TMA (128-byte swizzle at D >= 64, 64-byte at D <= 32; rows
// past T arrive as zeros) and their segment ids by cp.async, all landing
// on the stage's "full" mbarrier. Per stage and warpgroup: S = Q K^T
// (wgmma m64n128k16, both operands from shared memory, K-major), the
// online softmax on the accumulator fragment (mma.sync's m16n8 layout, so
// the row max and sum need only shuffles within a quad of lanes), then O
// += P V (wgmma, P straight from the accumulator registers rounded to
// bf16, V MN-major through the transposed descriptor). O is rescaled only
// when a row max of the warp moved.
// Each warp decides per stage, by one vote over the stage's segment ids
// (__all_sync), whether its 16 rows and the stage's 128 keys lie in one
// segment (and below T); only the stages where they do not pay the mask,
// and where the warp's rows lie in one segment (most of those stages: a
// stage crosses a segment's end far more often than 16 rows do), one id
// compare per key serves both of a thread's rows. Segment ids need not be
// monotonic: a stage with mixed ids takes the masked path whatever their
// order.
//
// What bounds it on the card: at ESM2-650M's shapes (D = 64, sequences of
// 100-1000 tokens) the operations: 4 D flops per same-segment pair and
// head on the tensor cores, and one exp per pair, which at D = 64 costs
// the SM's 16 exps per clock about as long as the products take on its
// tensor cores (256 flops per exp either way). What the design does:
// - the products are wgmma, issued once per warp and run asynchronously
//   from shared memory, where the mma.sync form loaded fragments and ran
//   softmax, products and loads in series;
// - two CTAs share an SM at D <= 64, so four warpgroups interleave their
//   products and exps, and one CTA's Q load and epilogue run under the
//   other's stages instead of being exposed at every one of the ~60 waves
//   of the inference batch (one CTA per SM took 1.34x as long; a
//   persistent CTA walking (q block, head) items would need a second Q
//   buffer and an item scheduler for what the second CTA gives);
// - 128-key stages: half the waits, votes and row reductions per key of
//   64-key tiles, and N = 128 products (7% faster at the 50k shape). The
//   64 score registers need 128 a thread, and two CTAs of 256 threads
//   allow 128, so there is no producer warp: a 288-thread CTA caps them
//   at 96 (its 18 warps put five on one of the SM's four register files);
// - the mask is skipped on one-segment stages and halved in cost where
//   only the keys cross a segment (5% at the 50k shape);
// - at D = 64 (prod64) an odd span's last stage runs over its first tile
//   alone, N = 64 products and a 64-key softmax, where the 128-key stage
//   computed a tile that matches no q row (on ESM2-650M's 50k inference
//   batch 3.0% of the tiles H1 walks, 2.4-3.4% of each of 4 ranks');
//   its p would be exact zeros, so the bits stay. Peeled out of the loop,
//   it keeps 128 registers and no wgmma serialisation (inside the loop,
//   ptxas serialised the products: 1.04x as long on an H100 80GB HBM3 at
//   700 W, tools/sm90_ab.py).
// Since the two CTAs an SM already interleave four warpgroups, what is
// left at D = 64 is not one pass: H6's map puts loads and barriers alone
// at 44% of the kernel and no compute pass above 16%, and on the inference
// batch the exps' bound at the H100's SFU rate (0.1737 ms) is the tensor
// cores' (0.1753). Measured and not kept at D = 64 (an H100 80GB HBM3 at
// 700 W, tools/sm90_ab.py, PERF.md): one CTA an SM with fwd_body_1cta's
// two stages in flight per warpgroup and three in the ring (1.31x), a
// quarter or an eighth of the exps on the FMA pipe by a degree-5
// polynomial (1.09x, 1.04x: that pipe is not idle either). Issuing S of
// the next stage before the softmax of this one (two stages in flight per
// warpgroup) ran no faster: the four warpgroups of an SM already keep it
// as busy. At D = 16 and 24 (ESM2-8M, -35M) the products shrink with D and
// the exps do not: one per pair at the SFU's 16 per SM per clock bounds
// the kernel, and the padded tiles cost products and L2 reads that this
// bound leaves room for. PERF.md has the H100's times.
//
// D = 128 (ESM2-15B) runs a body of its own, fwd_body_1cta. Q and a stage
// take 96 KiB and 256 threads need more than 128 registers, so one CTA
// fills the SM, and the products per key pair have doubled where the
// exps have not: the tensor cores bound it. Two warpgroups that each wait
// on their products before the softmax, and on the softmax before the
// next product (fwd_body), leave the tensor cores idle through every exp.
// There each warpgroup keeps two stages in flight: it issues S of stage
// j + 1, then O += P V of stage j, runs stage j + 1's softmax while P V
// runs, then rescales O, so O's updates and roundings keep fwd_body's
// order and the outputs its bits. A third stage keeps stage j + 1
// resident while the slot of stage j - 1 is refilled (with two, the
// loads were exposed: 1.4x as long), and P V is one N = 128 product per
// k-step (V's second box one LBO further) where fwd_body issues two of
// N = 64 (3.5% slower). Measured and not kept: warpgroups taking turns
// at the tensor cores by named barriers (ping-pong; no faster),
// persistent CTAs that walk (q block, head) items and prefetch the next
// Q (15% slower), and Q's A fragments in registers (248 registers, 0.6%
// faster on the inference batch).
//
// H5, the same kernel on token-minor operands (LAYOUT = HDT): q, k, v and
// o (H, D, T), lse (H, T), T % 8 == 0. Replaces the TPU kernel
// tools/fwd_T_experiment.py:_fwd_kernel_T (K14), which formed the scores
// transposed because the TPU reduces cheaply over sublanes; here only the
// shared-memory descriptors change. Each TMA box is one head's D rows over
// 64 tokens, 128 bytes wide at every D (128-byte swizzle), so a 128-row
// tile of H1 is two boxes of the same bytes. S = Q K^T takes Q and K^T
// MN-major (wgmma's transpose immediates), O += P V takes V as stored,
// (d, keys), K-major; the scores, the softmax and the mask vote are H1's.
// O leaves through the warpgroup's Q box, transposed and swizzled, by a
// TMA store that clips the tokens past T.
//
// H6, the kernel's ablation modes (MODE, D = 64 and LAYOUT = THD only):
// each removes one pass, as tools/flash_variants.py:32 variant_kernel
// (K17) does on the TPU, to measure what the pass costs; the outputs of
// every mode but BASELINE are wrong on purpose. MODE 0 is the production
// kernel, and esme_segment_flash_fwd_sm90 launches only that one;
// esme_segment_flash_fwd_sm90_variant launches any mode. Every dropped
// pass is an `if constexpr` branch (a guarded wgmma would be serialised
// by ptxas), and a mode without a product issues none of its
// fence/commit/wait. The modes take their meaning from this form's walk,
// 128-key stages that pair the span's 64-key tiles (an odd span's last
// stage reads the next tile, whose ids match no q row):
//   NOALPHA  the running max kept per stage; no rescale of l or O (alpha
//            is 1, so the rescale's vote never fires)
//   MAXFREE  no max: p = e^(s - 20), no rescale
//   SUMFREE  l sums the first key of each stage only
//   NOMAX    no max: p = e^s, no rescale
//   NOMASK   no vote and no mask on any stage (keys past T score 0)
//   NOEXP    p = s / 2 + 0.1 (s in base e, masked to -1e30), no max
//   BF16EXP  p = ex2.approx.ftz.bf16x2 of (s log2 e - m) rounded to bf16
//   NOPV     no P V product: O gains p's first 64 keys of each stage
//   NOQK     no Q K^T product: s = O[:, 0] + K[:, 0] (K's column 0 read
//            from the swizzled stage), unscaled. Its scores come from
//            register arithmetic, not a wgmma, and ptxas then spills a
//            little at the 128-register cap (24 bytes of stack; as much
//            with no K read at all); the other modes do not spill
//   NOTHING  no products and no softmax: the first element of the Q
//            tile, of each stage's K and V and of the q block's and the
//            stage's segment ids, summed, is added to every O element;
//            the ring, TMA and mbarriers run as in production
// The modes without a max (MAXFREE, NOMAX, NOEXP, NOTHING) keep m at
// -1e30 and write lse = -1e30 + log(l).
//
// H9, the rectangular form (flash_fwd_rect_sm90_kernel, the body at every
// head dim, THD, mode 0, in a kernel of its own): H1 with queries and keys
// of their own, Tq query rows with ids seg_q over Tk key rows with ids
// seg_k (context parallelism: a rank's tokens over the keys gathered from
// every rank). Replaces the forward of the TPU kernel K-rect,
// esme_tpu/ops/flash.py:1168 flash_rect_attention -> _fwd (K1 with
// segq_row != segk_col). Only the key side changes: its tensor maps have
// Tk rows, the stage loader copies seg_k's ids and zero-fills past Tk, and
// the stage's in-range count kn is taken against Tk; the grid, the q ids,
// the warp's one-segment vote, the o store and lse stay on the query side.
// The vote compares key ids with the q tile's, which is right because the
// ids are global on both sides. Nothing else differs: where H9 walks H1's
// span (a rank whose first row starts a q block), its o and lse are H1's
// bit for bit. A q block whose span is empty (no key shares its ids) walks
// no stage: o = 0, and lse is the running max of no key, -1e30 in base 2,
// times ln 2 (EMPTY_LSE in ops/flash.py).
// The work and what bounds it are H1's, over the rank's same-segment
// pairs; H1's instantiations compile as they did (the body is shared, not
// their parameters).
//
// The launch order (D = 64, THD, mode 0: prod64()). What holds H9 back
// beyond H1 is its last wave: a rank's grid is a quarter of H1's (98 q
// blocks x 20 heads on ESM2-650M's 50k batch split four ways: ~7.4 waves
// of the 264 CTAs two an SM hold, where H1 has ~30), and its spans run
// 1-15 stages. In q-block order the longest blocks land wherever the
// batch puts them, often in the last wave, which then runs long on a part
// of the card. With an order (ops/flash.py:fwd_order: the q blocks by
// falling span length, ties in q-block order, empty spans last, each
// block's span beside it) the CTA of linear index i = x + X y runs the
// block of entry i / H and head i % H: the card dispatches rising
// indices, so the longest blocks start first and the short ones fill the
// last wave, and a q block's heads run together (heads outer within a
// span length ran 1.02x as long on the ranks). The CTA reads its entry's
// block and span by independent loads, so the order adds no round of
// loads before its first TMA (reading the span through the block cost
// H1 2.6%). Each CTA computes what it did in q-block order, so o and lse
// keep their bits. On an H100 80GB HBM3 at 700 W (tools/sm90_ab.py,
// PERF.md) the order gains ~7% on a rank's grid and nothing on H1's 30
// waves (0.7% slower in the same turns), so H9 alone takes it: H1's
// kernel passes the body a null order. A null order keeps
// the grid's own (H5, H6 and every other instantiation compile as
// before).

#include <limits.h>

#include "sm90_common.cuh"

namespace {

using namespace esme;
using namespace esme::sm90;

constexpr int BQ = 128;        // q rows per CTA (two warpgroups)
constexpr int KT = 64;         // k rows per tile of the span
constexpr int KS = 2 * KT;     // k rows per stage: two tiles
constexpr int NTHREADS = 256;  // two warpgroups

// CTAs per SM: two where their registers fit (at most 128 a thread)
template <int D>
__host__ __device__ constexpr int ctas_per_sm() { return D > 64 ? 1 : 2; }

// two stages fit twice per SM at D = 64 (Q 16 KiB, a stage 32 KiB); four
// on D = 32's tiles; three once at D = 128 (Q 32 KiB, a stage 64 KiB), so
// that the stage after the one a warpgroup multiplies by V is in
// shared memory while the stage before it is refilled
template <int D>
__host__ __device__ constexpr int stages() {
  return D <= 32 ? 4 : ctas_per_sm<D>() == 2 ? 2 : 3;
}

template <int D>
struct FwdSmem {
  static constexpr int ST = stages<D>();
  static constexpr int Q_TILE = Geo<D>::template tile_bytes<BQ>();
  static constexpr int K_TILE = Geo<D>::template tile_bytes<KS>();
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_TILE;               // + 2 s K_TILE (k, v)
  static constexpr int IDS = K + 2 * ST * K_TILE;    // + s KS ids
  // the barriers right after the ids at D = 128 (rounded up to 1 KiB, the
  // three stages would need 56 bytes more than a block may take)
  static constexpr int BARS = ctas_per_sm<D>() == 1
                                  ? IDS + ST * KS * 4
                                  : align1k(IDS + ST * KS * 4);
  static constexpr int BYTES = BARS + (2 * ST + 1) * 8 + 1024;  // + alignment
  static_assert(BYTES <= 232448, "more shared memory than a block may take");
};

// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// H6's modes in K17's order (esme_tpu_torch/tools/flash_variants.py:MODES)
enum Mode {
  BASELINE = 0,
  NOALPHA,
  MAXFREE,
  SUMFREE,
  NOMAX,
  NOMASK,
  NOEXP,
  BF16EXP,
  NOPV,
  NOQK,
  NOTHING,
};

// 1.f, unknown to the compiler: NOALPHA keeps the production's vote on
// alpha (with alpha a constant 1 the schedule changes and spills)
__device__ __forceinline__ float opaque_one() {
  float one;
  asm("mov.b32 %0, 0x3f800000;\n" : "=f"(one));
  return one;
}

// modes in which m keeps its start value (-1e30) and alpha is 1
__host__ __device__ constexpr bool fixed_m(int mode) {
  return mode == MAXFREE || mode == NOMAX || mode == NOEXP ||
         mode == NOTHING;
}

// How a stage is masked, by each warp's vote: none, every key in the
// rows' segment; keys, the warp's 16 rows in one segment and the stage
// below T, so one id compare per key serves both of a thread's rows; any.
enum class Mask { none, keys, any };

// One stage's online-softmax step on this thread's scores s (rows r = g,
// g + 8 of the warp's 16, keys c = 8 j + 2 tq + e at register 4 j + 2 r +
// e): s becomes p = 2^(s scale_log2 - m) against the new running max m,
// l is this lane's share of the row sums, and alpha the factor that
// rescales the accumulator. Masked, a key of another segment or past T
// (c >= kn) scores -1e30 as in the mma.sync form. MODE drops a pass (see
// the header); its branches are compiled out of mode 0.
template <Mask MASK, int MODE, int N>
__device__ __forceinline__ void softmax_stage(float (&s)[N], float (&m)[2],
                                              float (&l)[2],
                                              float (&alpha)[2],
                                              const int* ids,
                                              const int (&sq)[2], int kn,
                                              int tq, float scale_log2) {
  constexpr bool masked = MASK != Mask::none;
  constexpr bool no_max = fixed_m(MODE);
  // scores scaled before the max and the exps (production folds the
  // scale of an unmasked stage into both)
  constexpr bool scaled = masked || no_max || MODE == BF16EXP;
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int c = 8 * j + 2 * tq;
    int2 id = make_int2(0, 0);
    if constexpr (masked) id = *reinterpret_cast<const int2*>(ids + c);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ide = e ? id.y : id.x;
      const bool in = ide == sq[0];   // both rows' answer under Mask::keys
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * j + 2 * r + e];
        if constexpr (masked) {
          const bool ok =
              MASK == Mask::keys ? in : c + e < kn && ide == sq[r];
          x = ok ? x * scale_log2 : NEG_INF;
        } else if constexpr (scaled) {
          x = __fmul_rn(x, scale_log2);   // rounded before any sum
        }
        if constexpr (!no_max) mx[r] = fmaxf(mx[r], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (no_max) {
      alpha[r] = 1.f;
    } else {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
      // unmasked scores are still raw: max(s) scale_log2 = max(s scale_log2)
      const float mn = fmaxf(m[r], scaled ? mx[r] : mx[r] * scale_log2);
      if constexpr (MODE == NOALPHA)
        alpha[r] = opaque_one();   // the rescale's vote stays, never fires
      else
        alpha[r] = ex2(m[r] - mn);
      m[r] = mn;
    }
  }
  float ps[2] = {0.f, 0.f};
  if constexpr (MODE == BF16EXP) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float* x = s + 4 * j + 2 * r;
        const uint32_t p2 = ex2_bf16x2(pack_bf16(x[0] - m[r], x[1] - m[r]));
        x[0] = bf16_lo(p2);
        x[1] = bf16_hi(p2);
        ps[r] += x[0];
        ps[r] += x[1];
      }
  } else {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = s[4 * j + 2 * r + e];
          if constexpr (MODE == NOEXP)
            x = x * 0.5f + 0.1f;
          else if constexpr (MODE == MAXFREE)
            x = ex2(x - 20.f * LOG2E);
          else if constexpr (MODE == NOMAX)
            x = ex2(x);
          else
            x = scaled ? ex2(x - m[r]) : ex2(fmaf(x, scale_log2, -m[r]));
          ps[r] += x;
        }
  }
  if constexpr (MODE == SUMFREE) {   // the stage's first key only
#pragma unroll
    for (int r = 0; r < 2; ++r) ps[r] = tq == 0 ? s[2 * r] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
}

// The operands' layout: THD, (T, H*D) (H1); HDT, token-minor (H, D, T)
// (H5, whose o goes out through tm_o)
enum Layout { THD = 0, HDT = 1 };

// H1's and H9's production kernel at D = 64 (ESM2-650M), for which the
// body was measured: it takes a launch order (ops/flash.py:fwd_order) and
// runs an odd span's last stage at N = 64; every other instantiation
// compiles as before, in the grid's own order
template <int D, int LAYOUT, int MODE>
__host__ __device__ constexpr bool prod64() {
  return D == 64 && LAYOUT == THD && MODE == BASELINE;
}

// The kernel's body, shared by H1 (and H5, H6) and H9: the queries have
// ids seg over T rows and the keys ids segk over Tk rows; H1's kernel
// passes its one seg and T for both, H9's kernel the two sides' own.
// order: the launch order (ops/flash.py:fwd_order), or null (q-block
// order); read where prod64().
template <int D, int LAYOUT, int MODE>
__device__ __forceinline__ void fwd_body(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_o, const int* __restrict__ seg,
    const int* __restrict__ segk, const int* __restrict__ kstart,
    const int* __restrict__ kend, bf16* __restrict__ o,
    float* __restrict__ lse, int T, int Tk, int H, float scale_log2,
    const int* __restrict__ order) {
  using G = Geo<D>;
  using L = FwdSmem<D>;
  constexpr bool hdt = LAYOUT == HDT;
  static_assert(MODE == BASELINE || (D == 64 && !hdt),
                "the ablation modes are built at D = 64, THD only");
  static_assert(D >= 32 || !hdt, "the token-minor layout takes D >= 32");
  using TG = TGeo<(D < 32 ? 32 : D)>;   // read only by the token-minor layout
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + ST;
  uint64_t* q_bar = empty + ST;
  auto k_rows = [&](int s) { return smem + L::K + 2 * s * L::K_TILE; };
  auto v_rows = [&](int s) { return smem + L::K + (2 * s + 1) * L::K_TILE; };
  auto ids = [&](int s) {
    return reinterpret_cast<int*>(smem + L::IDS) + s * KS;
  };

  // the CTA's (q block, head) and span: the grid's own, or with a launch
  // order (3 rows of X entries: q block, kstart, kend) entry r = i / H and
  // head i % H of the CTA's linear index i, which the card dispatches in
  // rising order: the longest spans start in the first wave, and a q
  // block's heads run together. The entry's three loads are independent,
  // as the grid's two span loads are.
  int qb = blockIdx.x;
  int h = blockIdx.y;
  int kb0, kb1;
  if (prod64<D, LAYOUT, MODE>() && order != nullptr) {
    const int i = blockIdx.x + gridDim.x * blockIdx.y;
    const int r = i / H;
    qb = order[r];
    kb0 = order[gridDim.x + r];
    kb1 = order[2 * gridDim.x + r];
    h = i - r * H;
  } else {
    kb0 = kstart[qb];
    kb1 = kend[qb];
  }
  const int HD = H * D;
  const int q0 = qb * BQ;
  const int col0 = h * D;
  const int ns = (max(kb1 - kb0, 0) + 1) / 2;   // stages of the span
  // an odd span's last stage, whose second tile matches no q row, runs
  // after the loop over its first tile alone (prod64)
  const bool odd =
      prod64<D, LAYOUT, MODE>() && kb1 > kb0 && ((kb1 - kb0) & 1);
  const int ns_full = ns - odd;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);   // expect_tx + warp 0's cp.async
      mbar_init(&empty[s], 8);       // one per warp
    }
    mbar_init(q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) >> 5;
  const int lane = threadIdx.x & 31;
  const bool loader = threadIdx.x < 32;
  // warp 0: stage j's k and v rows and ids, once its last round is back
  auto load = [&](int j) {
    const int s = j % ST;
    mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
    const int k0 = (kb0 + 2 * j) * KT;
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * L::K_TILE);
      if constexpr (hdt) {
#pragma unroll
        for (int b = 0; b < KS / TG::BOX; ++b) {
          tma_load_2d(k_rows(s) + b * TG::BOX_BYTES, &tm_k, &full[s],
                      k0 + b * TG::BOX, col0);
          tma_load_2d(v_rows(s) + b * TG::BOX_BYTES, &tm_v, &full[s],
                      k0 + b * TG::BOX, col0);
        }
      } else {
        tma_tile<D, KS>(k_rows(s), &tm_k, &full[s], col0, k0);
        tma_tile<D, KS>(v_rows(s), &tm_v, &full[s], col0, k0);
      }
    }
#pragma unroll
    for (int i = lane; i < KS; i += 32) {
      const int t = k0 + i;
      cp_async4(smem_u32(ids(s) + i), segk + (t < Tk ? t : 0), t < Tk);
    }
    mbar_arrive_cp_async(&full[s]);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(q_bar, L::Q_TILE);
      if constexpr (hdt) {
#pragma unroll
        for (int b = 0; b < BQ / TG::BOX; ++b)
          tma_load_2d(smem + L::Q + b * TG::BOX_BYTES, &tm_q, q_bar,
                      q0 + b * TG::BOX, col0);
      } else {
        tma_tile<D, BQ>(smem + L::Q, &tm_q, q_bar, col0, q0);
      }
    }
    for (int j = 0; j < ST - 1 && j < ns; ++j) load(j);
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = wg * 64 + warp * 16;   // the warp's first q row
  int row[2], sq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + row0 + r * 8 + g;
    sq[r] = row[r] < T ? seg[row[r]] : INT_MIN;
  }
  // one segment over the warp's 16 q rows?
  const int qid = lane < 16 && q0 + row0 + lane < T ? seg[q0 + row0 + lane]
                                                    : INT_MIN;
  const int qref = __shfl_sync(0xffffffffu, qid, 0);
  const bool quni = __all_sync(0xffffffffu, lane >= 16 || qid == qref);

  float acc[G::NH][G::HALF_COLS / 2];
#pragma unroll
  for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
    for (int i = 0; i < G::HALF_COLS / 2; ++i) acc[nh][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const uint32_t qs = smem_u32(smem + L::Q);
  mbar_wait(q_bar, 0);
  if constexpr (G::PAD) {
    // the warpgroup's 64 rows of Q: columns past D to 0 (threads 0-63)
    if (threadIdx.x % 128 < 64)
      zero_pad<D, BQ>(smem + L::Q, wg * 64 + threadIdx.x % 128);
    fence_proxy_async();
    named_barrier(1 + wg, 128);
  }
  for (int it = 0; it < ns_full; ++it) {
    if (loader && it + ST - 1 < ns) load(it + ST - 1);
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    const uint32_t ks = smem_u32(k_rows(s));
    const uint32_t vs = smem_u32(v_rows(s));
    const int* sid = ids(s);
    const int kn = Tk - (kb0 + 2 * it) * KT;   // the stage's k rows below Tk
    if constexpr (MODE == NOTHING) {
      // one element of each tile the stage and the block hold, in the
      // TPU kernel's order, into every accumulator
      const float t =
          (((__bfloat162float(*reinterpret_cast<const bf16*>(smem + L::Q)) +
             __bfloat162float(*reinterpret_cast<const bf16*>(k_rows(s)))) +
            __bfloat162float(*reinterpret_cast<const bf16*>(v_rows(s)))) +
           (float)seg[q0]) +
          (float)sid[0];
#pragma unroll
      for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
        for (int i = 0; i < G::HALF_COLS / 2; ++i) acc[nh][i] += t;
    } else {
      bool uni = true;
      if constexpr (MODE != NOMASK)
        uni = __all_sync(0xffffffffu, quni && kn >= KS &&
                                          sid[lane] == qref &&
                                          sid[lane + 32] == qref &&
                                          sid[lane + 64] == qref &&
                                          sid[lane + 96] == qref);

      float sc[64];
      if constexpr (MODE == NOQK) {
        // s = o[row, 0] + k[key, 0], unscaled: column 0 of the accumulator
        // lives in the quad's lane tq = 0, k's column 0 in the swizzled stage
        float a0[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a0[r] = __shfl_sync(0xffffffffu, acc[0][2 * r], lane & ~3);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float kc = __bfloat162float(*reinterpret_cast<const bf16*>(
                k_rows(s) + tile_offset<D, KS>(8 * j + 2 * tq + e, 0)));
#pragma unroll
            for (int r = 0; r < 2; ++r) sc[4 * j + 2 * r + e] = a0[r] + kc;
          }
      } else {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < G::KSTEPS; ++kk) {
          if constexpr (hdt)   // Q and K^T MN-major: tokens along the rows
            wgmma_ss_n128<1, 1>(sc, desc_t_mn<D>(qs + wg * TG::BOX_BYTES, kk),
                                desc_t_mn<D>(ks, kk), kk > 0);
          else
            wgmma_ss_n128(sc, desc_k<D, BQ>(qs, wg * 64, kk),
                          desc_k<D, KS>(ks, 0, kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
      }

      // the scores' scale: 1/sqrt(D) log2 e; log2 e on noqk's unscaled sums;
      // base e for noexp, whose p is linear in s
      const float sl = MODE == NOQK    ? LOG2E
                       : MODE == NOEXP ? scale_log2 * LN2
                                       : scale_log2;
      float alpha[2];
      if (uni)
        softmax_stage<Mask::none, MODE>(sc, m, l, alpha, sid, sq, kn, tq, sl);
      else if (quni && kn >= KS)
        softmax_stage<Mask::keys, MODE>(sc, m, l, alpha, sid, sq, kn, tq, sl);
      else
        softmax_stage<Mask::any, MODE>(sc, m, l, alpha, sid, sq, kn, tq, sl);

      uint32_t pa[KS / 16][4];
      if constexpr (MODE != NOPV) {
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) acc_to_a(pa[kk], sc, kk);
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
          for (int i = 0; i < G::HALF_COLS / 2; ++i)
            acc[nh][i] *= alpha[(i >> 1) & 1];
      }
      if constexpr (MODE == NOPV) {
        // o gains p's first 64 keys, unrounded: at D = 64 the first 32
        // score registers and the accumulator share one layout
#pragma unroll
        for (int i = 0; i < G::HALF_COLS / 2; ++i) acc[0][i] += sc[i];
      } else {
#pragma unroll
        for (int nh = 0; nh < G::NH; ++nh) fence_regs(acc[nh]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
          for (int nh = 0; nh < G::NH; ++nh) {
            if constexpr (hdt)   // V as stored, (d, keys): K-major
              wgmma_rs<0>(acc[nh], pa[kk], desc_t_k<D>(vs, kk, nh));
            else
              wgmma_rs(acc[nh], pa[kk], desc_mn<D, KS>(vs, kk, nh));
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int nh = 0; nh < G::NH; ++nh) fence_regs(acc[nh]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if constexpr (prod64<D, LAYOUT, MODE>()) {
    if (odd) {
      // S, the softmax, P and P V over the stage's first 64 keys (N = 64,
      // four k-steps of P V): the second tile's keys would score -1e30 and
      // add exact zeros to l and O, so the bits are the 128-key stage's.
      // Its ids match no q row, so the 128-key vote would fail: the masked
      // path runs, as it would have.
      const int it = ns - 1;
      const int s = it % ST;
      mbar_wait(&full[s], (it / ST) & 1);
      const uint32_t ks = smem_u32(k_rows(s));
      const uint32_t vs = smem_u32(v_rows(s));
      const int* sid = ids(s);
      const int kn = Tk - (kb0 + 2 * it) * KT;
      float sh[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G::KSTEPS; ++kk)
        wgmma_ss_n64(sh, desc_k<D, BQ>(qs, wg * 64, kk),
                     desc_k<D, KS>(ks, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sh);
      float alpha[2];
      if (quni && kn >= KS)
        softmax_stage<Mask::keys, MODE>(sh, m, l, alpha, sid, sq, kn, tq,
                                        scale_log2);
      else
        softmax_stage<Mask::any, MODE>(sh, m, l, alpha, sid, sq, kn, tq,
                                       scale_log2);
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) acc_to_a(pa[kk], sh, kk);
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < G::HALF_COLS / 2; ++i)
          acc[0][i] *= alpha[(i >> 1) & 1];
      }
      fence_regs(acc[0]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_rs(acc[0], pa[kk], desc_mn<D, KS>(vs, kk, 0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // epilogue: full row sums, o = acc / l into (T, H*D), lse into (H, T);
  // token-minor: o^T into the warpgroup's Q box (read by nothing once its
  // last S is done), swizzled as the box was loaded, then out by TMA,
  // which leaves the tokens past T unwritten
  unsigned char* obox = smem + L::Q + wg * TG::BOX_BYTES;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      lr += __shfl_xor_sync(0xffffffffu, lr, off);
    if constexpr (hdt) {
      const float inv = 1.f / (lr == 0.f ? 1.f : lr);
      const int qr = warp * 16 + r * 8 + g;   // the row's token in the box
#pragma unroll
      for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
        for (int j = 0; j < G::HALF_COLS / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = nh * G::HALF_COLS + 8 * j + 2 * tq + e;
            *reinterpret_cast<bf16*>(obox + d * 128 +
                                     (((qr >> 3) ^ (d & 7)) << 4) +
                                     (qr & 7) * 2) =
                __float2bfloat16_rn(acc[nh][4 * j + 2 * r + e] * inv);
          }
    }
    if (row[r] >= T) continue;
    lr = lr == 0.f ? 1.f : lr;
    if constexpr (!hdt) {
      const float inv = 1.f / lr;
      bf16* out = o + (size_t)row[r] * HD + col0;
#pragma unroll
      for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
        for (int j = 0; j < G::OWN_COLS / 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(out + nh * G::HALF_COLS +
                                             8 * j + 2 * tq) =
              __floats2bfloat162_rn(acc[nh][i] * inv, acc[nh][i + 1] * inv);
        }
    }
    if (tq == 0)
      lse[(size_t)h * T + row[r]] =
          fixed_m(MODE) ? NEG_INF + logf(lr) : m[r] * LN2 + logf(lr);
  }
  if constexpr (hdt) {
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      tma_store_2d(&tm_o, obox, q0 + wg * TG::BOX, col0);
      tma_store_wait();
    }
  }
}

// d (64 x 128 fp32) += A B, A (64 x 16 bf16) from registers, B (16 x 128)
// from shared memory, MN-major (TB = 1) or K-major (TB = 0): O += P V at
// D = 128 in one instruction per k-step (an MN-major B reads its second 64
// columns one box further, desc_mn's LBO)
template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
#define ESME_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define ESME_F16(i) ESME_F4(i), ESME_F4(i + 4), ESME_F4(i + 8), ESME_F4(i + 12)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, %70;\n}\n"
      : ESME_F16(0), ESME_F16(16), ESME_F16(32), ESME_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
#undef ESME_F16
#undef ESME_F4
}

// The body at D = 128 (one CTA per SM) for H1 (and H5) and H9, in
// fwd_body's place and with its arguments. Each warpgroup keeps two
// stages in flight: at step it it issues S of stage it + 1, then O += P V
// of stage it, waits for S alone and runs its softmax while P V runs,
// then waits for P V and rescales O by the new alpha. O's updates keep
// fwd_body's order, (O a_0 + P_0 V_0) a_1 + P_1 V_1 ..., and every
// rounding is fwd_body's (one N = 128 product per k-step of P V computes
// each element as the two N = 64 halves did), so the outputs are its bits.
// Warp 0 loads as in fwd_body, stage it + stages - 1 at the top of step
// it: with three stages, stage it + 1 stays resident while the slot of
// stage it - 1 is refilled.
template <int D, int LAYOUT>
__device__ __forceinline__ void fwd_body_1cta(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_o, const int* __restrict__ seg,
    const int* __restrict__ segk, const int* __restrict__ kstart,
    const int* __restrict__ kend, bf16* __restrict__ o,
    float* __restrict__ lse, int T, int Tk, int H, float scale_log2) {
  using G = Geo<D>;
  using L = FwdSmem<D>;
  using TG = TGeo<D>;
  constexpr bool hdt = LAYOUT == HDT;
  static_assert(ctas_per_sm<D>() == 1 && !G::PAD && G::NH == 2,
                "D = 128's body");
  constexpr int ST = L::ST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + ST;
  uint64_t* q_bar = empty + ST;
  auto k_rows = [&](int s) { return smem + L::K + 2 * s * L::K_TILE; };
  auto v_rows = [&](int s) { return smem + L::K + (2 * s + 1) * L::K_TILE; };
  auto ids = [&](int s) {
    return reinterpret_cast<int*>(smem + L::IDS) + s * KS;
  };

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int HD = H * D;
  const int q0 = qb * BQ;
  const int col0 = h * D;
  const int kb0 = kstart[qb];
  const int ns = (max(kend[qb] - kb0, 0) + 1) / 2;   // stages of the span

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1 + 32);   // expect_tx + warp 0's cp.async
      mbar_init(&empty[s], 8);       // one per warp
    }
    mbar_init(q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) >> 5;
  const int lane = threadIdx.x & 31;
  const bool loader = threadIdx.x < 32;
  // warp 0: stage j's k and v rows and ids, once its last round is back
  auto load = [&](int j) {
    const int s = j % ST;
    mbar_wait(&empty[s], ((j / ST) & 1) ^ 1);
    const int k0 = (kb0 + 2 * j) * KT;
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * L::K_TILE);
      if constexpr (hdt) {
#pragma unroll
        for (int b = 0; b < KS / TG::BOX; ++b) {
          tma_load_2d(k_rows(s) + b * TG::BOX_BYTES, &tm_k, &full[s],
                      k0 + b * TG::BOX, col0);
          tma_load_2d(v_rows(s) + b * TG::BOX_BYTES, &tm_v, &full[s],
                      k0 + b * TG::BOX, col0);
        }
      } else {
        tma_tile<D, KS>(k_rows(s), &tm_k, &full[s], col0, k0);
        tma_tile<D, KS>(v_rows(s), &tm_v, &full[s], col0, k0);
      }
    }
#pragma unroll
    for (int i = lane; i < KS; i += 32) {
      const int t = k0 + i;
      cp_async4(smem_u32(ids(s) + i), segk + (t < Tk ? t : 0), t < Tk);
    }
    mbar_arrive_cp_async(&full[s]);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(q_bar, L::Q_TILE);
      if constexpr (hdt) {
#pragma unroll
        for (int b = 0; b < BQ / TG::BOX; ++b)
          tma_load_2d(smem + L::Q + b * TG::BOX_BYTES, &tm_q, q_bar,
                      q0 + b * TG::BOX, col0);
      } else {
        tma_tile<D, BQ>(smem + L::Q, &tm_q, q_bar, col0, q0);
      }
    }
    for (int j = 0; j < ST - 1 && j < ns; ++j) load(j);
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int row0 = wg * 64 + warp * 16;   // the warp's first q row
  int row[2], sq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + row0 + r * 8 + g;
    sq[r] = row[r] < T ? seg[row[r]] : INT_MIN;
  }
  // one segment over the warp's 16 q rows?
  const int qid = lane < 16 && q0 + row0 + lane < T ? seg[q0 + row0 + lane]
                                                    : INT_MIN;
  const int qref = __shfl_sync(0xffffffffu, qid, 0);
  const bool quni = __all_sync(0xffffffffu, lane >= 16 || qid == qref);

  float acc[64];   // O: register 4 j + 2 r + e holds column 8 j + 2 tq + e
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float sc[64];
  uint32_t pa[KS / 16][4];
  float alpha[2];
  const uint32_t qs = smem_u32(smem + L::Q);

  // S = Q K^T of stage j into sc: issued and committed
  auto issue_s = [&](int j) {
    const uint32_t ks = smem_u32(k_rows(j % ST));
#pragma unroll
    for (int kk = 0; kk < G::KSTEPS; ++kk) {
      if constexpr (hdt)   // Q and K^T MN-major: tokens along the rows
        wgmma_ss_n128<1, 1>(sc, desc_t_mn<D>(qs + wg * TG::BOX_BYTES, kk),
                            desc_t_mn<D>(ks, kk), kk > 0);
      else
        wgmma_ss_n128(sc, desc_k<D, BQ>(qs, wg * 64, kk),
                      desc_k<D, KS>(ks, 0, kk), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of stage j, P from pa: issued and committed
  auto issue_pv = [&](int j) {
    const uint32_t vs = smem_u32(v_rows(j % ST));
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      if constexpr (hdt)   // V as stored, (d, keys): K-major
        wgmma_rs_n128<0>(acc, pa[kk], desc_t_k<D>(vs, kk, 0));
      else
        wgmma_rs_n128<1>(acc, pa[kk], desc_mn<D, KS>(vs, kk, 0));
    }
    wgmma_commit();
  };
  auto wait_full = [&](int j) { mbar_wait(&full[j % ST], (j / ST) & 1); };
  // stage j's vote: the warp's 16 rows and the stage's 128 keys in one
  // segment (and below Tk)?
  auto vote = [&](int j) {
    const int* sid = ids(j % ST);
    return __all_sync(0xffffffffu, quni && Tk - (kb0 + 2 * j) * KT >= KS &&
                                       sid[lane] == qref &&
                                       sid[lane + 32] == qref &&
                                       sid[lane + 64] == qref &&
                                       sid[lane + 96] == qref);
  };
  // stage j's softmax on sc, which holds its S
  auto softmax = [&](int j, bool uni) {
    const int* sid = ids(j % ST);
    const int kn = Tk - (kb0 + 2 * j) * KT;   // the stage's k rows below Tk
    if (uni)
      softmax_stage<Mask::none, BASELINE>(sc, m, l, alpha, sid, sq, kn, tq,
                                          scale_log2);
    else if (quni && kn >= KS)
      softmax_stage<Mask::keys, BASELINE>(sc, m, l, alpha, sid, sq, kn, tq,
                                          scale_log2);
    else
      softmax_stage<Mask::any, BASELINE>(sc, m, l, alpha, sid, sq, kn, tq,
                                         scale_log2);
  };
  // P of the stage whose softmax sc holds, and O rescaled by its alpha when
  // a row max of the warp moved
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) acc_to_a(pa[kk], sc, kk);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    fence_regs(acc);
  };
  // P V of stage j done: O valid, the stage's slot handed back
  auto release = [&](int j) {
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % ST]);
  };

  mbar_wait(q_bar, 0);
  if (ns > 0) {   // stage 0's S and softmax
    wait_full(0);
    wgmma_fence();
    issue_s(0);
    const bool uni = vote(0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0, uni);
  }
  for (int it = 0; it + 1 < ns; ++it) {
    if (loader && it + ST - 1 < ns) load(it + ST - 1);
    to_p();
    wait_full(it + 1);
    wgmma_fence();
    issue_s(it + 1);
    issue_pv(it);
    const bool uni = vote(it + 1);
    wgmma_wait<1>();   // S of stage it + 1; P V of stage it runs on
    fence_regs(sc);
    softmax(it + 1, uni);
    release(it);
  }
  if (ns > 0) {   // the last stage's P V
    to_p();
    wgmma_fence();
    issue_pv(ns - 1);
    release(ns - 1);
  }

  // epilogue: fwd_body's
  unsigned char* obox = smem + L::Q + wg * TG::BOX_BYTES;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      lr += __shfl_xor_sync(0xffffffffu, lr, off);
    if constexpr (hdt) {
      const float inv = 1.f / (lr == 0.f ? 1.f : lr);
      const int qr = warp * 16 + r * 8 + g;   // the row's token in the box
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * j + 2 * tq + e;
          *reinterpret_cast<bf16*>(obox + d * 128 +
                                   (((qr >> 3) ^ (d & 7)) << 4) +
                                   (qr & 7) * 2) =
              __float2bfloat16_rn(acc[4 * j + 2 * r + e] * inv);
        }
    }
    if (row[r] >= T) continue;
    lr = lr == 0.f ? 1.f : lr;
    if constexpr (!hdt) {
      const float inv = 1.f / lr;
      bf16* out = o + (size_t)row[r] * HD + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[i] * inv, acc[i + 1] * inv);
      }
    }
    if (tq == 0) lse[(size_t)h * T + row[r]] = m[r] * LN2 + logf(lr);
  }
  if constexpr (hdt) {
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      tma_store_2d(&tm_o, obox, q0 + wg * TG::BOX, col0);
      tma_store_wait();
    }
  }
}

template <int D, int LAYOUT, int MODE = BASELINE>
__global__ void __launch_bounds__(NTHREADS, ctas_per_sm<D>())
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o,
                      const int* __restrict__ seg,
                      const int* __restrict__ kstart,
                      const int* __restrict__ kend, bf16* __restrict__ o,
                      float* __restrict__ lse, int T, int H,
                      float scale_log2) {
  if constexpr (ctas_per_sm<D>() == 1) {
    static_assert(MODE == BASELINE, "the ablation modes are built at D = 64");
    fwd_body_1cta<D, LAYOUT>(tm_q, tm_k, tm_v, tm_o, seg, seg, kstart, kend,
                             o, lse, T, T, H, scale_log2);
  } else {   // H1 in q-block order
    fwd_body<D, LAYOUT, MODE>(tm_q, tm_k, tm_v, tm_o, seg, seg, kstart, kend,
                              o, lse, T, T, H, scale_log2, nullptr);
  }
}

// H9: T (Tq) query rows with ids seg_q over Tk key rows with ids seg_k
template <int D>
__global__ void __launch_bounds__(NTHREADS, ctas_per_sm<D>())
flash_fwd_rect_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const int* __restrict__ seg_q,
                           const int* __restrict__ seg_k,
                           const int* __restrict__ kstart,
                           const int* __restrict__ kend,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           int Tq, int Tk, int H, float scale_log2,
                           const int* __restrict__ order) {
  if constexpr (ctas_per_sm<D>() == 1)
    fwd_body_1cta<D, THD>(tm_q, tm_k, tm_v, tm_q, seg_q, seg_k, kstart, kend,
                          o, lse, Tq, Tk, H, scale_log2);
  else
    fwd_body<D, THD, BASELINE>(tm_q, tm_k, tm_v, tm_q, seg_q, seg_k, kstart,
                               kend, o, lse, Tq, Tk, H, scale_log2, order);
}

template <int D, int LAYOUT, int MODE = BASELINE>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg, const int* kstart, const int* kend,
                   void* o, float* lse, int T, int H, float scale,
                   cudaStream_t stream) {
  using L = FwdSmem<D>;
  CUtensorMap tq, tk, tv, to;
  const int HD = H * D;
  cudaError_t err;
  if constexpr (LAYOUT == HDT) {
    if ((err = token_map<D>(&tq, q, T, HD)) != cudaSuccess ||
        (err = token_map<D>(&tk, k, T, HD)) != cudaSuccess ||
        (err = token_map<D>(&tv, v, T, HD)) != cudaSuccess ||
        (err = token_map<D>(&to, o, T, HD)) != cudaSuccess)
      return err;
  } else {
    if ((err = tile_map<D>(&tq, q, T, HD, BQ)) != cudaSuccess ||
        (err = tile_map<D>(&tk, k, T, HD, KS)) != cudaSuccess ||
        (err = tile_map<D>(&tv, v, T, HD, KS)) != cudaSuccess)
      return err;
    to = tq;   // not read
  }
  auto kernel = flash_fwd_sm90_kernel<D, LAYOUT, MODE>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((T + BQ - 1) / BQ, H), NTHREADS, L::BYTES, stream>>>(
      tq, tk, tv, to, seg, kstart, kend, static_cast<bf16*>(o), lse, T, H,
      scale * LOG2E);
  return cudaGetLastError();
}

template <int LAYOUT>
int launch_d(const void* q, const void* k, const void* v, const void* seg,
             const void* kstart, const void* kend, void* o, void* lse, int T,
             int H, int D, float scale, void* stream) {
  const int* s = static_cast<const int*>(seg);
  const int* ks = static_cast<const int*>(kstart);
  const int* ke = static_cast<const int*>(kend);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (LAYOUT == THD) {   // the padded head dims: THD only
    if (D == 16)
      return (int)launch<16, THD>(q, k, v, s, ks, ke, o, l, T, H, scale, st);
    if (D == 24)
      return (int)launch<24, THD>(q, k, v, s, ks, ke, o, l, T, H, scale, st);
  }
  switch (D) {
    case 32:
      return (int)launch<32, LAYOUT>(q, k, v, s, ks, ke, o, l, T, H, scale,
                                     st);
    case 64:
      return (int)launch<64, LAYOUT>(q, k, v, s, ks, ke, o, l, T, H, scale,
                                     st);
    case 128:
      return (int)launch<128, LAYOUT>(q, k, v, s, ks, ke, o, l, T, H, scale,
                                      st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t launch_rect(const void* q, const void* k, const void* v,
                        const int* seg_q, const int* seg_k, const int* kstart,
                        const int* kend, void* o, float* lse, int Tq, int Tk,
                        int H, float scale, cudaStream_t stream,
                        const int* order) {
  using L = FwdSmem<D>;
  if (order != nullptr && !prod64<D, THD, BASELINE>())
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const int HD = H * D;
  cudaError_t err;
  if ((err = tile_map<D>(&tq, q, Tq, HD, BQ)) != cudaSuccess ||
      (err = tile_map<D>(&tk, k, Tk, HD, KS)) != cudaSuccess ||
      (err = tile_map<D>(&tv, v, Tk, HD, KS)) != cudaSuccess)
    return err;
  auto kernel = flash_fwd_rect_sm90_kernel<D>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((Tq + BQ - 1) / BQ, H), NTHREADS, L::BYTES, stream>>>(
      tq, tk, tv, seg_q, seg_k, kstart, kend, static_cast<bf16*>(o), lse, Tq,
      Tk, H, scale * LOG2E, order);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// H1: q, k, v, o (T, H*D). D in {16, 24, 32, 64, 128}. Returns the
// cudaError_t of the launch (0 on success).
int esme_segment_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                const void* seg, const void* kstart,
                                const void* kend, void* o, void* lse, int T,
                                int H, int D, float scale, void* stream) {
  return launch_d<THD>(q, k, v, seg, kstart, kend, o, lse, T, H, D, scale,
                       stream);
}

// H5: the same function on token-minor q, k, v, o (H, D, T); T % 8 == 0;
// D in {32, 64, 128}.
int esme_flash_fwd_t_sm90(const void* q, const void* k, const void* v,
                          const void* seg, const void* kstart,
                          const void* kend, void* o, void* lse, int T, int H,
                          int D, float scale, void* stream) {
  return launch_d<HDT>(q, k, v, seg, kstart, kend, o, lse, T, H, D, scale,
                       stream);
}

// H9: H1 with per-side ids and lengths, q and o (Tq, H*D), k and v (Tk,
// H*D), lse (H, Tq). D in {16, 24, 32, 64, 128}. order: null (q-block
// order) or, at D = 64, the launch order, (3, nqb) int32: q blocks,
// kstart, kend (ops/flash.py:fwd_order); the last argument, so a build from
// before it runs q-block order on the same call.
int esme_segment_flash_fwd_rect_sm90(const void* q, const void* k,
                                     const void* v, const void* seg_q,
                                     const void* seg_k, const void* kstart,
                                     const void* kend, void* o, void* lse,
                                     int Tq, int Tk, int H, int D,
                                     float scale, void* stream,
                                     const void* order) {
  const int* sq = static_cast<const int*>(seg_q);
  const int* sk = static_cast<const int*>(seg_k);
  const int* ks = static_cast<const int*>(kstart);
  const int* ke = static_cast<const int*>(kend);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ord = static_cast<const int*>(order);
  switch (D) {
    case 16:
      return (int)launch_rect<16>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H,
                                  scale, st, ord);
    case 24:
      return (int)launch_rect<24>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H,
                                  scale, st, ord);
    case 32:
      return (int)launch_rect<32>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H,
                                  scale, st, ord);
    case 64:
      return (int)launch_rect<64>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H,
                                  scale, st, ord);
    case 128:
      return (int)launch_rect<128>(q, k, v, sq, sk, ks, ke, o, l, Tq, Tk, H,
                                   scale, st, ord);
    default: return (int)cudaErrorInvalidValue;
  }
}

// H6: H1 (THD) in ablation mode `mode` (enum Mode), D = 64 only; mode 0
// is H1's own instantiation.
int esme_segment_flash_fwd_sm90_variant(int mode, const void* q,
                                        const void* k, const void* v,
                                        const void* seg, const void* kstart,
                                        const void* kend, void* o, void* lse,
                                        int T, int H, int D, float scale,
                                        void* stream) {
  const int* s = static_cast<const int*>(seg);
  const int* ks = static_cast<const int*>(kstart);
  const int* ke = static_cast<const int*>(kend);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64) return (int)cudaErrorInvalidValue;
#define ESME_FWD_MODE(M) \
  case M:                \
    return (int)launch<64, THD, M>(q, k, v, s, ks, ke, o, l, T, H, scale, st);
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

const char* esme_flash_fwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
