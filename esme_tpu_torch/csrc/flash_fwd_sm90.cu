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
// = m + log(l) in base e, fp32, (H, T). Head dims 32, 64 and 128; the
// wrapper sends 16 and 24 to the mma.sync form (a 24-column TMA box would
// read the next head's columns).
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
// and V rows by TMA (128-byte swizzle at D >= 64, 64-byte at D = 32; rows
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
//   only the keys cross a segment (5% at the 50k shape).
// Issuing S of the next stage before the softmax of this one (two stages
// in flight per warpgroup) ran no faster: the four warpgroups of an SM
// already keep it as busy. PERF.md has the H100's times.
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

#include <limits.h>

#include "sm90_common.cuh"

namespace {

using namespace esme;
using namespace esme::sm90;

constexpr int BQ = 128;        // q rows per CTA (two warpgroups)
constexpr int KT = 64;         // k rows per tile of the span
constexpr int KS = 2 * KT;     // k rows per stage: two tiles
constexpr int NTHREADS = 256;  // two warpgroups

// two stages fit twice per SM at D = 64 (Q 16 KiB, a stage 32 KiB)
template <int D>
__host__ __device__ constexpr int stages() { return D == 32 ? 4 : 2; }

// CTAs per SM: two where their registers fit (at most 128 a thread)
template <int D>
__host__ __device__ constexpr int ctas_per_sm() { return D > 64 ? 1 : 2; }

template <int D>
struct FwdSmem {
  static constexpr int ST = stages<D>();
  static constexpr int Q_TILE = Geo<D>::template tile_bytes<BQ>();
  static constexpr int K_TILE = Geo<D>::template tile_bytes<KS>();
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_TILE;               // + 2 s K_TILE (k, v)
  static constexpr int IDS = K + 2 * ST * K_TILE;    // + s KS ids
  static constexpr int BARS = align1k(IDS + ST * KS * 4);
  static constexpr int BYTES = BARS + (2 * ST + 1) * 8 + 1024;  // + alignment
};

// 2^x, flushing results below 2^-126 to 0 (one MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// (c >= kn) scores -1e30 as in the mma.sync form.
template <Mask MASK, int N>
__device__ __forceinline__ void softmax_stage(float (&s)[N], float (&m)[2],
                                              float (&l)[2],
                                              float (&alpha)[2],
                                              const int* ids,
                                              const int (&sq)[2], int kn,
                                              int tq, float scale_log2) {
  constexpr bool masked = MASK != Mask::none;
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
        }
        mx[r] = fmaxf(mx[r], x);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    // unmasked scores are still raw: max(s) scale_log2 = max(s scale_log2)
    const float mn = fmaxf(m[r], masked ? mx[r] : mx[r] * scale_log2);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = s[4 * j + 2 * r + e];
        x = masked ? ex2(x - m[r]) : ex2(fmaf(x, scale_log2, -m[r]));
        ps[r] += x;
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ps[r];
}

// The operands' layout: THD, (T, H*D) (H1); HDT, token-minor (H, D, T)
// (H5, whose o goes out through tm_o)
enum Layout { THD = 0, HDT = 1 };

template <int D, int LAYOUT>
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
  using G = Geo<D>;
  using L = FwdSmem<D>;
  using TG = TGeo<D>;
  constexpr int ST = L::ST;
  constexpr bool hdt = LAYOUT == HDT;
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
      cp_async4(smem_u32(ids(s) + i), seg + (t < T ? t : 0), t < T);
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
  for (int it = 0; it < ns; ++it) {
    if (loader && it + ST - 1 < ns) load(it + ST - 1);
    const int s = it % ST;
    mbar_wait(&full[s], (it / ST) & 1);
    const uint32_t ks = smem_u32(k_rows(s));
    const uint32_t vs = smem_u32(v_rows(s));
    const int* sid = ids(s);
    const int kn = T - (kb0 + 2 * it) * KT;   // the stage's k rows below T
    const bool uni = __all_sync(0xffffffffu, quni && kn >= KS &&
                                                 sid[lane] == qref &&
                                                 sid[lane + 32] == qref &&
                                                 sid[lane + 64] == qref &&
                                                 sid[lane + 96] == qref);

    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
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

    float alpha[2];
    if (uni)
      softmax_stage<Mask::none>(sc, m, l, alpha, sid, sq, kn, tq,
                                scale_log2);
    else if (quni && kn >= KS)
      softmax_stage<Mask::keys>(sc, m, l, alpha, sid, sq, kn, tq,
                                scale_log2);
    else
      softmax_stage<Mask::any>(sc, m, l, alpha, sid, sq, kn, tq,
                               scale_log2);

    uint32_t pa[KS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) acc_to_a(pa[kk], sc, kk);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int nh = 0; nh < G::NH; ++nh)
#pragma unroll
        for (int i = 0; i < G::HALF_COLS / 2; ++i)
          acc[nh][i] *= alpha[(i >> 1) & 1];
    }
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
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
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
        for (int j = 0; j < G::HALF_COLS / 8; ++j) {
          const int i = 4 * j + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(out + nh * G::HALF_COLS +
                                             8 * j + 2 * tq) =
              __floats2bfloat162_rn(acc[nh][i] * inv, acc[nh][i + 1] * inv);
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

template <int D, int LAYOUT>
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
  auto kernel = flash_fwd_sm90_kernel<D, LAYOUT>;
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

}  // namespace

extern "C" {

// H1: q, k, v, o (T, H*D). D in {32, 64, 128}. Returns the cudaError_t of
// the launch (0 on success).
int esme_segment_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                const void* seg, const void* kstart,
                                const void* kend, void* o, void* lse, int T,
                                int H, int D, float scale, void* stream) {
  return launch_d<THD>(q, k, v, seg, kstart, kend, o, lse, T, H, D, scale,
                       stream);
}

// H5: the same function on token-minor q, k, v, o (H, D, T); T % 8 == 0.
int esme_flash_fwd_t_sm90(const void* q, const void* k, const void* v,
                          const void* seg, const void* kstart,
                          const void* kend, void* o, void* lse, int T, int H,
                          int D, float scale, void* stream) {
  return launch_d<HDT>(q, k, v, seg, kstart, kend, o, lse, T, H, D, scale,
                       stream);
}

const char* esme_flash_fwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
