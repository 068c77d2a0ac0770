// H5: segment-flash attention forward with transposed scores, on
// token-minor operands, for Hopper (sm_90a).
//
// Replaces the TPU kernel tools/fwd_T_experiment.py:_fwd_kernel_T (K14,
// launched by fwd_T at :115), the experiment that moved the TPU's
// production forward to transposed scores: the same function as H1
// (segment-masked softmax(q k^T / sqrt(D)) v, online softmax in fp32,
// rows with l == 0 kept finite, o in bf16 and lse = m + log(l) in fp32),
// but with q, k, v and o token-minor, (H, D, T), and lse (H, T).
//
// The question it asks on this card: what the transposed orientation
// costs. The scores are formed as S^T = K Q^T, keys on the mma's rows and
// queries on its columns, so each query's max and sum run over the
// accumulator's rows: within a lane over its m-tiles and row halves, then
// across the 8 lanes of a column (shuffles xor 4, 8, 16), three shuffles
// per query where H1 needs two per row within a quad. Each warp owns 32
// queries (16 at D >= 64) and all 64 keys of the tile, so no reduction
// crosses warps. (At D = 64, 32 queries per warp took 255 registers and
// spilled; 16 take 142 and ran 8% faster on an H100 80GB HBM3 at 700 W,
// tools/fwd_T_experiment.py.) The token-minor
// tiles sit in shared memory as (D rows, tokens): K and Q^T reach the
// mma through ldmatrix .trans, V^T through plain ldmatrix.
//
// O^T = V^T P^T needs P^T as the B operand (keys as the contraction,
// queries as n), but the accumulator holds P^T with keys as rows: lane
// 4 g + tq has keys g, g + 8 of queries 2 tq, 2 tq + 1, and the B
// fragment wants keys 2 tq, 2 tq + 1 (and + 8) of query g. Each 8 x 8
// block is packed to bf16 and transposed in registers by one
// movmatrix.trans, two per 16 x 8 accumulator tile; nothing goes through
// shared memory.
//
// What bounds it: the same products as H1 (operations-bound at ESM2-650M's
// shapes), plus the wider reductions and the transposes. k/v tiles are
// double-buffered by cp.async where T % 8 == 0 (16-byte aligned rows),
// and copied element by element otherwise; rows are padded by 16 bytes
// against bank conflicts. o is stored from the accumulator layout, two
// tokens per store.
//
// Head dims: padded widths DP in {16, 32, 64, 128}; D = 24 runs in the
// DP = 32 kernel with rows d >= 24 zero-filled (scale stays 1/sqrt(24)).

#include "flash_common.cuh"

namespace {

using namespace esme;

constexpr int BQ = 128;  // queries per block (the mma's columns)
constexpr int BK = 64;   // keys per tile (the mma's rows)

// Per head width: NQW queries per warp, NWARPS warps per 128-query block.
// Shared memory: the q tile, two stages of (k tile, v tile), two stages
// of the k tile's segment ids; tiles are DP rows of tokens padded by 8.
template <int DP>
struct Cfg {
  static constexpr int NQW = DP <= 32 ? 32 : 16;
  static constexpr int NWARPS = BQ / NQW;
  static constexpr int NTHREADS = NWARPS * 32;
  static constexpr int LDQ = BQ + 8;
  static constexpr int LDK = BK + 8;
  static constexpr int QTILE = DP * LDQ;
  static constexpr int KTILE = DP * LDK;
  static constexpr size_t bytes = (size_t)(QTILE + 4 * KTILE) * 2 + 2 * BK * 4;
};

// Start the copies of tokens [t0, t0 + NCOL) of rows d < DP of one head's
// (D, T) slice into a tile with row stride LD; rows d >= D and tokens
// past T are zero-filled. vec (T % 8 == 0): 16-byte cp.async chunks, each
// wholly inside or outside [0, T); otherwise element by element, at once.
template <int DP, int LD, int NCOL, int NTHREADS>
__device__ __forceinline__ void load_cols(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int t0, int T, int D, bool vec) {
  if (vec) {
    constexpr int CPR = NCOL / 8;
    for (int i = threadIdx.x; i < DP * CPR; i += NTHREADS) {
      const int d = i / CPR;
      const int c = (i % CPR) * 8;
      const bool valid = d < D && t0 + c < T;
      const bf16* g = valid ? src + (size_t)d * T + t0 + c : src;
      cp_async16(smem_u32(dst + d * LD + c), g, valid);
    }
  } else {
    for (int i = threadIdx.x; i < DP * NCOL; i += NTHREADS) {
      const int d = i / NCOL;
      const int c = i % NCOL;
      dst[d * LD + c] = d < D && t0 + c < T ? src[(size_t)d * T + t0 + c]
                                            : __float2bfloat16(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(Cfg<DP>::NTHREADS)
flash_fwd_t_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ seg,
                   const int* __restrict__ kstart,
                   const int* __restrict__ kend, bf16* __restrict__ o,
                   float* __restrict__ lse, int T, int D, float scale_log2,
                   int vec) {
  using C = Cfg<DP>;
  constexpr int LDQ = C::LDQ;
  constexpr int LDK = C::LDK;
  constexpr int NJ = C::NQW / 8;  // 8-query n-tiles per warp
  constexpr int KM = BK / 16;     // 16-key m-tiles of S^T, k-steps of O^T
  constexpr int KD = DP / 16;     // 16-wide d steps of S^T, m-tiles of O^T
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  int* segk = reinterpret_cast<int*>(smem + (size_t)(C::QTILE + 4 * C::KTILE) * 2);

  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int q0 = qb * BQ;
  const int wq = warp * C::NQW;  // the warp's first query in the block
  const size_t hoff = (size_t)h * D * T;
  const int kb0 = kstart[qb];
  const int kb1 = kend[qb];

  // this thread's queries: n-tile j, column e -> q0 + wq + 8 j + 2 tq + e
  // (queries past T match nothing and are not written)
  int sq[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = q0 + wq + j * 8 + tq * 2 + e;
      sq[j][e] = t < T ? seg[t] : -2;
    }

  auto k_tile = [&](int s) { return Qs + C::QTILE + 2 * s * C::KTILE; };
  auto v_tile = [&](int s) { return Qs + C::QTILE + (2 * s + 1) * C::KTILE; };
  auto load_kv = [&](int kb, int s) {
    const int k0 = kb * BK;
    load_cols<DP, LDK, BK, C::NTHREADS>(k_tile(s), k + hoff, k0, T, D, vec);
    load_cols<DP, LDK, BK, C::NTHREADS>(v_tile(s), v + hoff, k0, T, D, vec);
    load_words<C::NTHREADS>(segk + s * BK, seg, k0, BK, T);
  };

  load_cols<DP, LDQ, BQ, C::NTHREADS>(Qs, q + hoff, q0, T, D, vec);
  if (kb0 < kb1) load_kv(kb0, 0);
  cp_async_commit();

  // per query (j, e): running max (base 2) and this lane's share of the
  // sum; O^T's accumulator: m-tile dm holds d = 16 dm + g (+ 8)
  float mrun[NJ][2], lrun[NJ][2];
  float acc[KD][NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    mrun[j][0] = mrun[j][1] = NEG_INF;
    lrun[j][0] = lrun[j][1] = 0.f;
#pragma unroll
    for (int dm = 0; dm < KD; ++dm)
      acc[dm][j][0] = acc[dm][j][1] = acc[dm][j][2] = acc[dm][j][3] = 0.f;
  }

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

    // S^T = K Q^T: the tile's 64 keys on the rows, the warp's queries on
    // the columns; each K fragment feeds NJ products, each Q^T fragment
    // (read from shared memory at every step) KM
    float st[KM][NJ][4];
#pragma unroll
    for (int mt = 0; mt < KM; ++mt)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        st[mt][j][0] = st[mt][j][1] = st[mt][j][2] = st[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qf[NJ][2];  // Q^T as B: d = 16 kk + 2 tq (+ 8), query g
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_trans(b, a_addr<LDQ>(Qs, kk * 16, wq + jp * 16, lane));
        qf[2 * jp][0] = b[0];
        qf[2 * jp][1] = b[1];
        qf[2 * jp + 1][0] = b[2];
        qf[2 * jp + 1][1] = b[3];
      }
#pragma unroll
      for (int mt = 0; mt < KM; ++mt) {
        uint32_t a[4];
        ldsm_x4_trans(a, b_addr<LDK>(Kt, kk * 16, mt * 16, lane));
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(st[mt][j], a, qf[j][0], qf[j][1]);
      }
    }

    // mask and scale; lane holds keys 16 mt + 8 r + g of queries (j, e)
    float mx[NJ][2];
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx[j][0] = mx[j][1] = NEG_INF;
#pragma unroll
    for (int mt = 0; mt < KM; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = mt * 16 + r * 8 + g;
        const int skc = k0 + c < T ? sk[c] : -1;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = st[mt][j][2 * r + e];
            x = skc == sq[j][e] ? x * scale_log2 : NEG_INF;
            mx[j][e] = fmaxf(mx[j][e], x);
          }
      }

    // online softmax over the keys: the column max across the 8 lanes
    // that share tq, then exp2, the lane's sum and the rescale of O^T
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mx[j][e] = fmaxf(mx[j][e], __shfl_xor_sync(0xffffffffu, mx[j][e], off));
        const float mn = fmaxf(mrun[j][e], mx[j][e]);
        const float alpha = exp2f(mrun[j][e] - mn);
        mrun[j][e] = mn;
        float ps = 0.f;
#pragma unroll
        for (int mt = 0; mt < KM; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& p = st[mt][j][2 * r + e];
            p = exp2f(p - mn);
            ps += p;
          }
        lrun[j][e] = lrun[j][e] * alpha + ps;
#pragma unroll
        for (int dm = 0; dm < KD; ++dm) {
          acc[dm][j][e] *= alpha;
          acc[dm][j][2 + e] *= alpha;
        }
      }

    // O^T += V^T P^T, one 16-key step at a time: P^T's two 8 x 8 blocks
    // of each n-tile, packed to bf16 and transposed, are the B fragment
#pragma unroll
    for (int mt = 0; mt < KM; ++mt) {
      uint32_t pb[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        pb[j][0] = movmatrix_trans(pack_bf16(st[mt][j][0], st[mt][j][1]));
        pb[j][1] = movmatrix_trans(pack_bf16(st[mt][j][2], st[mt][j][3]));
      }
#pragma unroll
      for (int dm = 0; dm < KD; ++dm) {
        uint32_t a[4];
        ldsm_x4(a, a_addr<LDK>(Vt, dm * 16, mt * 16, lane));
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[dm][j], a, pb[j][0], pb[j][1]);
      }
    }
  }
  cp_async_wait_all();

  // epilogue: full column sums, o^T = acc / l into (H, D, T), lse (H, T)
  const bool pairs = (T & 1) == 0;  // two tokens per 4-byte aligned store
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float l = lrun[j][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      l = l == 0.f ? 1.f : l;
      inv[e] = 1.f / l;
      const int t = q0 + wq + j * 8 + tq * 2 + e;
      if (g == 0 && t < T)
        lse[(size_t)blockIdx.y * T + t] = mrun[j][e] * LN2 + logf(l);
    }
    const int t = q0 + wq + j * 8 + tq * 2;
#pragma unroll
    for (int dm = 0; dm < KD; ++dm)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = dm * 16 + r * 8 + g;
        if (d >= D) continue;
        bf16* orow = o + hoff + (size_t)d * T;
        const float x0 = acc[dm][j][2 * r] * inv[0];
        const float x1 = acc[dm][j][2 * r + 1] * inv[1];
        if (pairs && t + 1 < T) {
          *reinterpret_cast<__nv_bfloat162*>(orow + t) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (t < T) orow[t] = __float2bfloat16(x0);
          if (t + 1 < T) orow[t + 1] = __float2bfloat16(x1);
        }
      }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* seg, const int* kstart, const int* kend,
                   void* o, float* lse, int T, int H, int D, float scale,
                   cudaStream_t stream) {
  const size_t smem = Cfg<DP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_t_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H);
  flash_fwd_t_kernel<DP><<<grid, Cfg<DP>::NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), seg, kstart, kend, static_cast<bf16*>(o),
      lse, T, D, scale * LOG2E, T % 8 == 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (H, D, T) bf16; seg (T,) int32; kstart, kend: H1's spans
// (ceil(T / 128) q blocks over 64-key tiles); lse (H, T) fp32. Returns
// the cudaError_t of the launch (0 on success).
int esme_flash_fwd_t(const void* q, const void* k, const void* v,
                     const void* seg, const void* kstart, const void* kend,
                     void* o, void* lse, int T, int H, int D, float scale,
                     void* stream) {
  const int* s = static_cast<const int*>(seg);
  const int* ks = static_cast<const int*>(kstart);
  const int* ke = static_cast<const int*>(kend);
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
    case 24:
    case 32: return launch<32>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
    case 64: return launch<64>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
    case 128: return launch<128>(q, k, v, s, ks, ke, o, l, T, H, D, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* esme_flash_fwd_t_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
