// H8's streaming probes dma and dma_t for Hopper (sm_90a): k and v tiles
// streamed by TMA through an mbarrier ring of 128-key stages on H1's
// Hopper geometry, and dma's pair mode, in which a 2-CTA cluster loads the
// tiles that its two q blocks both read once, by TMA multicast.
//
// Replaces, as the cp.async form (probes.cu) did, the TPU probes
// tools/profile_attn.py:155 dma_kernel (dma) and tools/profile_attn.py:209
// extra's dma_kernel (dma_t). The function is the cp.async form's: q block
// i (of nqb = ceil(T / 128), one CTA per (q block, head)) reads n_i =
// kend[i] - kstart[i] 64-key tiles, (i + j) % nkb for j < n_i, as the TPU
// probe's index map walks them. dma writes o = q + bf16(t), t the sum over
// d of k + v at the first row of the block's last tile; dma_t takes k and
// v token-minor, (H, 64, T) seen as (H*64, T), and writes t (the tile's
// first token) in fp32 into (H, nqb). Rows past T arrive as zeros. The
// outputs are bit-equal to the cp.async form's: the same sums in the same
// lane order (row0_sum, token0_sum).
//
// What bounds it on the card: not DRAM. The walk reads each tile again
// for every q block whose walk covers it: at the 50k inference batch (T =
// 50,176, 20 heads) 13.2 q blocks read each of the 401 tiles a head's walk
// covers, 1.74 GB of tiles per call against 0.128 GB for each of q, k, v
// and o (tools/profile_attn.py:work counts them). The limit is the
// stream of tiles from L2 into the SMs' shared memory, and the latency of
// each CTA's first tile. The cp.async form keeps one 64-key tile pair in
// flight per CTA, its addresses computed and issued by all 128 threads.
// What this design does:
// - one thread issues each stage as one or two TMA boxes per tensor, and
//   one warp waits on it and hands it back; no thread spends registers or
//   issue slots on addresses, and the consumer's work per stage is one
//   mbarrier wait and one arrive;
// - 128-key stages (two 64-key tiles of k and two of v, 32 KiB) in a ring
//   on full/empty mbarriers; a CTA alone keeps H1's Hopper geometry, two
//   stages and two CTAs per SM, so that up to 128 KiB per SM are in flight
//   and one CTA's first tile and epilogue run under the other's stream (a
//   pair: one stage, four CTAs per SM; stages(), ctas_per_sm());
// - the q block arrives by TMA at the start, under the stream, and o
//   leaves by one TMA store of that box (which clips the rows past T);
// - the pair mode (CLUSTER = 2, dma only) takes q blocks 2c and 2c + 1 of
//   one head in a cluster. Block 2c + 1 walks block 2c's tiles moved by
//   one, so the pair's walks unite into one run of tiles: each tile both
//   blocks read comes from L2 once, multicast into the same ring slot of
//   both CTAs (issued by rank 0; 0.60 of the tiles at the 50k batch),
//   and a tile only one reads goes to that CTA alone. Each CTA's full
//   barrier expects the bytes that land in it; every slot is handed back
//   on the empty barriers of both CTAs, so neither producer refills a
//   slot before both consumers are done with it. An odd nqb leaves the
//   last cluster's second CTA without a block: it walks the ring with
//   nothing to load.
//
// The walk of one unit (one q block, or a pair; the same on the host:
// esme_tpu_torch/tools/profile_attn.py:stream_walk): positions p in
// [lo, hi), block r of the unit (first block i0) reading positions
// [r, r + n_r) of tiles (i0 + p) % nkb; two positions per stage. A stage
// is one 128-row box per tensor when its two tiles are adjacent and go to
// the same CTAs, else two 64-row boxes (the walk wraps past nkb - 1, or
// one block's walk ends inside the stage); an odd walk's last stage is
// one 64-row box. No tile outside the walk is loaded.
//
// D = 64 (ESM2-650M's head dim) only; dma_t needs T % 8 == 0 (TMA's row
// stride, 2 T bytes, a multiple of 16).

#include <limits.h>

#include "sm90_common.cuh"

namespace {

using namespace esme;
using namespace esme::sm90;

constexpr int BQ = 128;          // q rows per CTA
constexpr int BK = 64;           // keys per tile of the walk
constexpr int DH = 64;           // head dim
constexpr int ROW = 2 * DH;      // bytes per tile row (k, v; token-minor d)
constexpr int BOX = BK * ROW;    // one 64-key tile of one tensor: 8 KiB
constexpr int NTHREADS = 128;    // warp 0 loads, warp 1 consumes; all: o

// Ring depth and CTAs per SM by cluster size, chosen on the H100 (PERF.md,
// H8): a CTA alone runs best on H1's geometry, two 32 KiB stages and two
// CTAs per SM (a deeper ring at one CTA per SM, or one stage at four, is
// slower); a pair, whose every slot waits on both CTAs, best with one
// stage and four CTAs per SM
__host__ __device__ constexpr int stages(int cluster) {
  return cluster == 1 ? 2 : 1;
}
__host__ __device__ constexpr int ctas_per_sm(int cluster) {
  return cluster == 1 ? 2 : 4;
}

enum Layout { THD = 0, HDT = 1 };  // dma: (T, H*64); dma_t: (H*64, T)

template <int CLUSTER>
struct Smem {
  static constexpr int STAGES = stages(CLUSTER);
  static constexpr int CTAS_PER_SM = ctas_per_sm(CLUSTER);
  static constexpr int Q = 0;                      // the q block (dma), 16 KiB
  static constexpr int KV = Q + BQ * ROW;          // + s SLOT: k, k, v, v boxes
  static constexpr int SLOT = 4 * BOX;             // one stage: 32 KiB
  static constexpr int BARS = KV + STAGES * SLOT;  // full, empty, q
  static constexpr int T_SUM = BARS + (2 * STAGES + 1) * 8;
  static constexpr int USED = T_SUM + 16 + 1024;   // + alignment
  // padded so that exactly CTAS_PER_SM CTAs fit an SM's 228 KiB, each
  // with 1 KiB reserved
  static constexpr int SM_BYTES = 233472;
  static constexpr int FLOOR = SM_BYTES / (CTAS_PER_SM + 1) - 1024 + 16;
  static constexpr int BYTES = USED > FLOOR ? USED : FLOOR;
  static_assert(CTAS_PER_SM * (BYTES + 1024) <= SM_BYTES,
                "CTAS_PER_SM CTAs fit one SM");
};

// The sum over d of x[0][d] + y[0][d] (first row of two row-major tiles,
// whose first row the 128-byte swizzle leaves in place), by one warp: lane
// l takes d = 2 l, 2 l + 1 (probes.cu's row0_sum)
__device__ __forceinline__ float row0_sum(const unsigned char* x,
                                          const unsigned char* y, int lane) {
  const bf16* a = reinterpret_cast<const bf16*>(x);
  const bf16* b = reinterpret_cast<const bf16*>(y);
  float t = (__bfloat162float(a[2 * lane]) + __bfloat162float(b[2 * lane])) +
            (__bfloat162float(a[2 * lane + 1]) +
             __bfloat162float(b[2 * lane + 1]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

// The same over the first token of two token-minor boxes (row d, 128
// bytes, holds d's 64 tokens; the swizzle moves token 0 of row d to chunk
// d % 8), in the cp.async form's order
__device__ __forceinline__ float token0_sum(const unsigned char* x,
                                            const unsigned char* y,
                                            int lane) {
  auto at = [](const unsigned char* box, int d) {
    return __bfloat162float(
        *reinterpret_cast<const bf16*>(box + d * ROW + ((d & 7) << 4)));
  };
  float t = (at(x, 2 * lane) + at(y, 2 * lane)) +
            (at(x, 2 * lane + 1) + at(y, 2 * lane + 1));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

// One box of k and one of v (from tile t of the walk, one or two tiles as
// the maps' boxes are) into a stage's k and v halves, for the CTAs in
// `mask`: multicast by rank 0 when it is every CTA of the cluster, loaded
// by its CTA when it is one
template <int LAYOUT, int CLUSTER>
__device__ __forceinline__ void load_box(unsigned char* kd, unsigned char* vd,
                                         const CUtensorMap* tk,
                                         const CUtensorMap* tv, uint64_t* bar,
                                         int t, int col0, int mask,
                                         int rank) {
  // THD: box (column, row); HDT: box (token, row of the (H*64, T) view)
  const int x = LAYOUT == THD ? col0 : t * BK;
  const int y = LAYOUT == THD ? t * BK : col0;
  if (CLUSTER > 1 && mask == (1 << CLUSTER) - 1) {
    if (rank == 0) {
      tma_load_2d_multicast(kd, tk, bar, x, y, (uint16_t)mask);
      tma_load_2d_multicast(vd, tv, bar, x, y, (uint16_t)mask);
    }
  } else if (mask == 1 << rank) {
    tma_load_2d(kd, tk, bar, x, y);
    tma_load_2d(vd, tv, bar, x, y);
  }
}

// H8 dma (THD) and dma_t (HDT). tm_q / tm_o: the q and o blocks (dma);
// tm_k / tm_v: 64-key boxes; tm_k2 / tm_v2: 128-key boxes (dma). out:
// dma_t's (H, nqb) fp32.
template <int LAYOUT, int CLUSTER>
__global__ void __launch_bounds__(NTHREADS, ctas_per_sm(CLUSTER))
stream_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_o,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_k2,
                   const __grid_constant__ CUtensorMap tm_v2,
                   const int* __restrict__ kstart,
                   const int* __restrict__ kend, float* __restrict__ out,
                   int T, int nqb) {
  static_assert(CLUSTER == 1 || (CLUSTER == 2 && LAYOUT == THD),
                "pairs: dma only");
  constexpr bool thd = LAYOUT == THD;
  using L = Smem<CLUSTER>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* q_bar = empty + STAGES;
  float* tsum = reinterpret_cast<float*>(smem + L::T_SUM);

  const int rank = CLUSTER == 1 ? 0 : (int)cluster_ctarank();
  const int qb = blockIdx.x;
  const int i0 = qb - rank;             // the unit's first q block
  const bool own = qb < nqb;            // not a pair's CTA past the end
  const int h = blockIdx.y;
  const int col0 = h * DH;
  const int nkb = (T + BK - 1) / BK;
  // the unit's walk: block r reads positions [r, r + n[r]); all of them
  // make one run [lo, hi)
  int n[CLUSTER];
  int lo = INT_MAX, hi = 0, mine = 0;   // mine: n[rank], read unrolled
#pragma unroll
  for (int r = 0; r < CLUSTER; ++r) {
    n[r] = i0 + r < nqb ? max(kend[i0 + r] - kstart[i0 + r], 0) : 0;
    if (n[r] > 0) {
      lo = min(lo, r);
      hi = max(hi, r + n[r]);
    }
    if (r == rank) mine = n[r];
  }
  const int ns = hi > lo ? (hi - lo + 1) / 2 : 0;   // stages
  auto mask = [&](int p) {
    int m = 0;
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) m |= (p >= r && p < r + n[r]) << r;
    return m;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);          // the producer's expect_tx
      mbar_init(&empty[s], CLUSTER);   // each CTA's consumer warp
    }
    mbar_init(q_bar, 1);
    fence_barrier_init();
  }
  if constexpr (CLUSTER > 1)
    cluster_sync();
  else
    __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    // producer: the q block, then stage j once its last round is back
    if (thd && own && lane == 0) {
      mbar_expect_tx(q_bar, BQ * ROW);
      tma_load_2d(smem + L::Q, &tm_q, q_bar, col0, qb * BQ);
    }
    for (int j = 0; j < ns; ++j) {
      const int s = j % STAGES;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      if (lane == 0) {
        const int p = lo + 2 * j;
        const bool two = p + 1 < hi;
        const int t0 = (i0 + p) % nkb;
        const int t1 = (i0 + p + 1) % nkb;
        const int m0 = mask(p);
        const int m1 = two ? mask(p + 1) : 0;
        mbar_expect_tx(&full[s],
                       2 * BOX * (((m0 >> rank) & 1) + ((m1 >> rank) & 1)));
        unsigned char* kd = smem + L::KV + s * L::SLOT;
        unsigned char* vd = kd + 2 * BOX;
        if (thd && two && t1 == t0 + 1 && m1 == m0) {
          load_box<LAYOUT, CLUSTER>(kd, vd, &tm_k2, &tm_v2, &full[s], t0,
                                    col0, m0, rank);
        } else {
          load_box<LAYOUT, CLUSTER>(kd, vd, &tm_k, &tm_v, &full[s], t0,
                                    col0, m0, rank);
          if (two)
            load_box<LAYOUT, CLUSTER>(kd + BOX, vd + BOX, &tm_k, &tm_v,
                                      &full[s], t1, col0, m1, rank);
        }
      }
      __syncwarp();
    }
  } else if (warp == 1) {
    // consumer: every stage waited on and handed back to the CTAs whose
    // producers fill it; the sum from this block's last tile (position
    // rank + n - 1 of the run)
    const int last = mine > 0 ? rank + mine - 1 - lo : -1;
    float t = 0.f;
    for (int j = 0; j < ns; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      if (last >= 0 && j == last / 2) {
        const unsigned char* kt =
            smem + L::KV + s * L::SLOT + (last & 1) * BOX;
        t = thd ? row0_sum(kt, kt + 2 * BOX, lane)
                : token0_sum(kt, kt + 2 * BOX, lane);
      }
      __syncwarp();
      if (lane == 0) {
        if constexpr (CLUSTER > 1) {
          // this CTA's own barrier first: the other CTA's producer refills
          // only after this arrival, so no arrival of the other consumer's
          // next round can reach this barrier before this one does
#pragma unroll
          for (int i = 0; i < CLUSTER; ++i)
            mbar_arrive_cluster(&empty[s], (rank + i) % CLUSTER);
        } else {
          mbar_arrive(&empty[s]);
        }
      }
    }
    if (lane == 0) {
      if (thd)
        *tsum = t;
      else
        out[(size_t)h * nqb + qb] = t;
    }
  }

  if (thd && own) {
    // o = q + bf16(t) in the q box (an element at a time, so its swizzle
    // does not matter), out by one TMA store
    __syncthreads();
    mbar_wait(q_bar, 0);
    const float tb = __bfloat162float(__float2bfloat16(*tsum));
    uint4* x = reinterpret_cast<uint4*>(smem + L::Q);
    for (int i = threadIdx.x; i < BQ * ROW / 16; i += NTHREADS) {
      uint4 v = x[i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = pack_bf16(bf16_lo(w[c]) + tb, bf16_hi(w[c]) + tb);
      x[i] = v;
    }
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_store_2d(&tm_o, smem + L::Q, col0, qb * BQ);
      tma_store_wait();
    }
  }
  if constexpr (CLUSTER > 1) cluster_sync();
}

template <int LAYOUT, int CLUSTER>
cudaError_t launch(const CUtensorMap (&m)[6], const int* kstart,
                   const int* kend, float* out, int T, int H,
                   cudaStream_t stream) {
  using L = Smem<CLUSTER>;
  auto kernel = stream_sm90_kernel<LAYOUT, CLUSTER>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const int nqb = (T + BQ - 1) / BQ;
  const dim3 grid((nqb + CLUSTER - 1) / CLUSTER * CLUSTER, H);
  if constexpr (CLUSTER == 1) {
    kernel<<<grid, NTHREADS, L::BYTES, stream>>>(
        m[0], m[1], m[2], m[3], m[4], m[5], kstart, kend, out, T, nqb);
  } else {
    err = launch_clustered(kernel, grid, dim3(NTHREADS), L::BYTES, stream,
                           CLUSTER, m[0], m[1], m[2], m[3], m[4], m[5],
                           kstart, kend, out, T, nqb);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success). Grids are
// (nqb, H) over H1's spans kstart/kend (nqb = ceil(T / 128)), rounded up
// to whole clusters.

// dma: q, k, v, o (T, H * 64) bf16; cluster 1 (a CTA per q block) or 2
// (pairs of q blocks sharing their common tiles by multicast).
int esme_probe_dma_sm90(const void* q, const void* k, const void* v,
                        const void* kstart, const void* kend, void* o, int T,
                        int H, int cluster, void* stream) {
  const int HD = H * DH;
  CUtensorMap m[6];
  cudaError_t err;
  if ((err = tile_map<DH>(&m[0], q, T, HD, BQ)) != cudaSuccess ||
      (err = tile_map<DH>(&m[1], o, T, HD, BQ)) != cudaSuccess ||
      (err = tile_map<DH>(&m[2], k, T, HD, BK)) != cudaSuccess ||
      (err = tile_map<DH>(&m[3], v, T, HD, BK)) != cudaSuccess ||
      (err = tile_map<DH>(&m[4], k, T, HD, 2 * BK)) != cudaSuccess ||
      (err = tile_map<DH>(&m[5], v, T, HD, 2 * BK)) != cudaSuccess)
    return (int)err;
  const int* ks = static_cast<const int*>(kstart);
  const int* ke = static_cast<const int*>(kend);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cluster) {
    case 1: return (int)launch<THD, 1>(m, ks, ke, nullptr, T, H, st);
    case 2: return (int)launch<THD, 2>(m, ks, ke, nullptr, T, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dma_t: kT, vT (H, 64, T) bf16, T % 8 == 0; out (H, nqb) fp32.
int esme_probe_dma_t_sm90(const void* kT, const void* vT, const void* kstart,
                          const void* kend, void* out, int T, int H,
                          void* stream) {
  CUtensorMap m[6];
  cudaError_t err;
  if ((err = token_map<DH>(&m[2], kT, T, H * DH)) != cudaSuccess ||
      (err = token_map<DH>(&m[3], vT, T, H * DH)) != cudaSuccess)
    return (int)err;
  m[0] = m[1] = m[4] = m[2];   // not read
  m[5] = m[3];
  return (int)launch<HDT, 1>(m, static_cast<const int*>(kstart),
                             static_cast<const int*>(kend),
                             static_cast<float*>(out), T, H,
                             static_cast<cudaStream_t>(stream));
}

const char* esme_probe_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
