// H8: ceiling probes for H1's passes, each alone, for Hopper (sm_90a).
//
// Replaces the TPU probes of tools/profile_attn.py (K16): vpu_kernel (81),
// mxu_kernel (115), dma_kernel (155) and extra's dma_kernel (209), which
// timed the attention forward's softmax passes, its two products and its
// k/v streams apart, to tell which one sets the kernel's time. Each probe
// here runs one of H1's passes over H1's own grid and step count: one
// block per (128-row q block, head), walking as many 64-key steps as H1
// walks for that block (kend - kstart of H1's spans), so its time is that
// pass's share of H1 at the same shape with everything else taken away.
//
// - vpu: a resident (128, 64) fp32 score tile in H1's accumulator layout
//   (4 warps x 32 rows, registers); per step the scale, the row max (in
//   the lane, then the quad), exp2 and the row sum, nothing loaded and no
//   product. A step's scores carry 0 * the last step's sums, so no step
//   can be hoisted out of the loop. Output: each row's sum(exp(s - max
//   s)), written by the first q block of each head. Bound: the exps at the
//   SFU rate.
// - mxu: resident q (128, 64) and k (64, 64) tiles (v = k, as the TPU
//   probe passes k twice); per step H1's two products on mma.sync, S =
//   Q K^T from q fragments held in registers and k fragments read by
//   ldmatrix, then O += bf16(S) V, with no softmax between them. Output:
//   O / steps = bf16(q k^T) k, from the first q block of each head.
//   Bound: the products at the bf16 tensor-core rate.
// - dma: k and v tiles (64 rows of one head's 64 columns of (T, H*D))
//   streamed by cp.async, double-buffered as in H1, over tiles (i + j) %
//   nkb for q block i and step j as the TPU probe walks them; per step one
//   warp sums the first row of both tiles. Output: o = q + bf16(the last
//   step's sum), the q block read and written once. Bound: bytes.
// - dma_t: the same from token-minor (H, D, T) k and v (64 d rows of 64
//   tokens, 128-byte rows), summing the tile's first token over d; no q.
//   Output: (H, nqb) fp32 sums of each block's last tile.
//
// D = 64 (ESM2-650M's head dim) only; dma_t needs T % 8 == 0.

#include "flash_common.cuh"

namespace {

using namespace esme;

constexpr int BQ = 128;
constexpr int BK = 64;
constexpr int DH = 64;
constexpr int LD = DH + 8;
constexpr int NWARPS = 4;            // 32 q rows (two m-tiles) per warp
constexpr int NTHREADS = NWARPS * 32;

__global__ void __launch_bounds__(NTHREADS)
vpu_kernel(const float* __restrict__ s, const int* __restrict__ kstart,
           const int* __restrict__ kend, float* __restrict__ out,
           float zero) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // x0[m][j][2 r + e]: row (2 warp + m) * 16 + 8 r + g, key 8 j + 2 tq + e
  float x0[2][BK / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        x0[m][j][c] = s[((warp * 2 + m) * 16 + (c >> 1) * 8 + g) * BK + j * 8 +
                        tq * 2 + (c & 1)];
  float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  const int n = kend[blockIdx.x] - kstart[blockIdx.x];
  for (int it = 0; it < n; ++it) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float b = l[m][r] * zero;
        float x[BK / 8][2];
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[j][e] = fmaf(x0[m][j][2 * r + e], LOG2E, b);
            mx = fmaxf(mx, x[j][e]);
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) ps += exp2f(x[j][e] - mx);
        l[m][r] = ps;
      }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[m][r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (blockIdx.x == 0 && tq == 0)
        out[blockIdx.y * BQ + (warp * 2 + m) * 16 + r * 8 + g] = sum;
    }
}

__global__ void __launch_bounds__(NTHREADS)
mxu_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const int* __restrict__ kstart, const int* __restrict__ kend,
           bf16* __restrict__ out) {
  __shared__ __align__(128) bf16 Qs[BQ * LD];
  __shared__ __align__(128) bf16 Ks[BK * LD];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  for (int i = threadIdx.x; i < BQ * DH / 8; i += NTHREADS)
    cp_async16(smem_u32(Qs + (i / 8) * LD + (i % 8) * 8), q + i * 8, true);
  for (int i = threadIdx.x; i < BK * DH / 8; i += NTHREADS)
    cp_async16(smem_u32(Ks + (i / 8) * LD + (i % 8) * 8), k + i * 8, true);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[2][DH / 16][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      ldsm_x4(qf[m][kk], a_addr<LD>(Qs, (warp * 2 + m) * 16, kk * 16, lane));
  float acc[2][DH / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      acc[m][d][0] = acc[m][d][1] = acc[m][d][2] = acc[m][d][3] = 0.f;

  const int n = kend[blockIdx.x] - kstart[blockIdx.x];
  for (int it = 0; it < n; ++it) {
    float sc[2][BK / 8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        sc[m][j][0] = sc[m][j][1] = sc[m][j][2] = sc[m][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, b_addr<LD>(Ks, jp * 16, kk * 16, lane));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(sc[m][2 * jp], qf[m][kk], b[0], b[1]);
          mma_bf16(sc[m][2 * jp + 1], qf[m][kk], b[2], b[3]);
        }
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) acc_to_a(pa[m], sc[m][2 * kk], sc[m][2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, a_addr<LD>(Ks, kk * 16, dp * 16, lane));
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][2 * dp], pa[m], b[0], b[1]);
          mma_bf16(acc[m][2 * dp + 1], pa[m], b[2], b[3]);
        }
      }
    }
  }
  if (blockIdx.x != 0 || n == 0) return;
  const float inv = 1.f / n;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bf16* orow = out + ((size_t)blockIdx.y * BQ + (warp * 2 + m) * 16 + r * 8 + g) * DH;
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + tq * 2) =
            __floats2bfloat162_rn(acc[m][d][2 * r] * inv,
                                  acc[m][d][2 * r + 1] * inv);
    }
}

// The sum over d of x[0][d] + y[0][d] (first row of two tiles with row
// stride LD), by one warp: lane l takes d = 2 l, 2 l + 1.
__device__ __forceinline__ float row0_sum(const bf16* x, const bf16* y,
                                          int lane) {
  float t = (__bfloat162float(x[2 * lane]) + __bfloat162float(y[2 * lane])) +
            (__bfloat162float(x[2 * lane + 1]) +
             __bfloat162float(y[2 * lane + 1]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

__global__ void __launch_bounds__(NTHREADS)
dma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const int* __restrict__ kstart,
           const int* __restrict__ kend, bf16* __restrict__ o, int T, int H) {
  __shared__ __align__(128) bf16 KV[4 * BK * LD];
  __shared__ float tsum;
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int HD = H * DH;
  const int col0 = h * DH;
  const int nkb = (T + BK - 1) / BK;
  const int n = kend[qb] - kstart[qb];
  auto load_kv = [&](int j, int s) {
    const int k0 = ((qb + j) % nkb) * BK;
    load_rows<DH, LD, BK, NTHREADS>(KV + 2 * s * BK * LD, k, k0, T, HD, col0, DH);
    load_rows<DH, LD, BK, NTHREADS>(KV + (2 * s + 1) * BK * LD, v, k0, T, HD, col0, DH);
  };
  if (n > 0) load_kv(0, 0);
  cp_async_commit();
  float t = 0.f;
  for (int j = 0; j < n; ++j) {
    const int s = j & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n) load_kv(j + 1, s ^ 1);
    cp_async_commit();
    if (warp == 0)
      t = row0_sum(KV + 2 * s * BK * LD, KV + (2 * s + 1) * BK * LD, lane);
  }
  cp_async_wait_all();
  if (threadIdx.x == 0) tsum = t;
  __syncthreads();
  // o = q + bf16(t), the q block read and o written once, 16 bytes a thread
  const float tb = __bfloat162float(__float2bfloat16(tsum));
  for (int i = threadIdx.x; i < BQ * DH / 8; i += NTHREADS) {
    const int row = qb * BQ + i / (DH / 8);
    if (row >= T) continue;
    const size_t off = (size_t)row * HD + col0 + (i % (DH / 8)) * 8;
    uint4 x = *reinterpret_cast<const uint4*>(q + off);
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = pack_bf16(bf16_lo(w[c]) + tb, bf16_hi(w[c]) + tb);
    *reinterpret_cast<uint4*>(o + off) = x;
  }
}

__global__ void __launch_bounds__(NTHREADS)
dma_t_kernel(const bf16* __restrict__ kT, const bf16* __restrict__ vT,
             const int* __restrict__ kstart, const int* __restrict__ kend,
             float* __restrict__ out, int T) {
  constexpr int LDT = BK + 8;
  __shared__ __align__(128) bf16 KV[4 * DH * LDT];
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nkb = (T + BK - 1) / BK;
  const int n = kend[qb] - kstart[qb];
  const bf16* kh = kT + (size_t)h * DH * T;
  const bf16* vh = vT + (size_t)h * DH * T;
  auto load_kv = [&](int j, int s) {
    const int t0 = ((qb + j) % nkb) * BK;
    for (int i = threadIdx.x; i < 2 * DH * (BK / 8); i += NTHREADS) {
      const int w = i / (DH * (BK / 8));      // 0: k, 1: v
      const int d = (i / (BK / 8)) % DH;
      const int c = (i % (BK / 8)) * 8;
      const bool valid = t0 + c < T;
      const bf16* src = (w ? vh : kh) + (valid ? (size_t)d * T + t0 + c : 0);
      cp_async16(smem_u32(KV + (2 * s + w) * DH * LDT + d * LDT + c), src,
                 valid);
    }
  };
  if (n > 0) load_kv(0, 0);
  cp_async_commit();
  float t = 0.f;
  for (int j = 0; j < n; ++j) {
    const int s = j & 1;
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n) load_kv(j + 1, s ^ 1);
    cp_async_commit();
    if (warp == 0) {
      // the tile's first token over d: lane l takes d = 2 l, 2 l + 1
      const bf16* kt = KV + 2 * s * DH * LDT;
      const bf16* vt = KV + (2 * s + 1) * DH * LDT;
      float x = (__bfloat162float(kt[2 * lane * LDT]) +
                 __bfloat162float(vt[2 * lane * LDT])) +
                (__bfloat162float(kt[(2 * lane + 1) * LDT]) +
                 __bfloat162float(vt[(2 * lane + 1) * LDT]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      t = x;
    }
  }
  cp_async_wait_all();
  if (threadIdx.x == 0) out[(size_t)h * gridDim.x + qb] = t;
}

}  // namespace

extern "C" {

// Each returns the cudaError_t of its launch (0 on success). Grids are
// (nqb, H) over H1's spans kstart/kend (nqb = ceil(T / 128)).

// s: (128, 64) fp32; out: (H, 128) fp32.
int esme_probe_vpu(const void* s, const void* kstart, const void* kend,
                   void* out, int nqb, int H, void* stream) {
  vpu_kernel<<<dim3(nqb, H), NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s), static_cast<const int*>(kstart),
      static_cast<const int*>(kend), static_cast<float*>(out), 0.f);
  return (int)cudaGetLastError();
}

// q: (128, 64), k: (64, 64) bf16; out: (H, 128, 64) bf16.
int esme_probe_mxu(const void* q, const void* k, const void* kstart,
                   const void* kend, void* out, int nqb, int H,
                   void* stream) {
  mxu_kernel<<<dim3(nqb, H), NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const int*>(kstart), static_cast<const int*>(kend),
      static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// q, k, v, o: (T, H * 64) bf16.
int esme_probe_dma(const void* q, const void* k, const void* v,
                   const void* kstart, const void* kend, void* o, int T,
                   int H, void* stream) {
  dma_kernel<<<dim3((T + BQ - 1) / BQ, H), NTHREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int*>(kstart),
      static_cast<const int*>(kend), static_cast<bf16*>(o), T, H);
  return (int)cudaGetLastError();
}

// kT, vT: (H, 64, T) bf16, T % 8 == 0; out: (H, nqb) fp32.
int esme_probe_dma_t(const void* kT, const void* vT, const void* kstart,
                     const void* kend, void* out, int T, int H,
                     void* stream) {
  if (T % 8) return (int)cudaErrorInvalidValue;
  dma_t_kernel<<<dim3((T + BQ - 1) / BQ, H), NTHREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(kT), static_cast<const bf16*>(vT),
      static_cast<const int*>(kstart), static_cast<const int*>(kend),
      static_cast<float*>(out), T);
  return (int)cudaGetLastError();
}

const char* esme_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
