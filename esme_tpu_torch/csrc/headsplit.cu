// H4: head relayout with optional RoPE for Hopper (sm_90a).
//
// Replaces the TPU kernels esme_tpu/ops/headsplit.py:_split_kernel
// ((T, H*D) -> three (H, T, D), RoPE on q and k), :_merge_kernel
// ((H, T, D) -> (T, H*D), optional rotation or counter-rotation),
// :_split_one_kernel ((T, H*D) -> (H, T, D)) and :_split_kernel_t
// ((T, H*D) -> q (H, T, D), k and v token-minor (H, D, T), RoPE on q and
// k); it also runs :_rot_one_kernel_t, :_split_one_kernel_t and
// :_merge_kernel_t as functions (the model path does without them: H1,
// H2 and H3 work in the (T, H*D) layout).
//
// One launch moves up to three bf16 tensors of the same logical shape
// (T, H, D). Each tensor has its own source and destination layout among
//   thd = (T, H*D), htd = (H, T, D), hdt = (H, D, T)
// and its own rotation: none, R or R^T, with per-token (T, D) cos/sin
// tables of which the first D/2 columns are read (as the TPU kernels
// read cos[:, :D/2]). The rotation is H3's arithmetic in the half-split
// convention,
//   y[:h2] = x1 * c - x2 * s,   y[h2:] = x2 * c + x1 * s
// (s negated for R^T), with each product and each sum rounded to bf16 as
// the plain PyTorch version (esme_tpu_torch/ops/rotary.py:apply_rotary)
// rounds them, so the two agree bit for bit. A move without rotation
// copies the bits.
//
// What bounds it on the card: bytes. Each tensor is read once and
// written once (4 * T * H * D bytes per tensor) plus the tables; the
// rotation is 6 flops per element. Three kernels; the wrapper
// (esme_tpu_torch/ops/headsplit.py:relayout_route) picks one per launch by
// a static rule on the layouts and T:
//
// * rows: every move keeps D contiguous (thd <-> htd). A (t, h) row is D
//   contiguous elements on both sides, so no staging is needed: a thread
//   holds one vector of each half (elements i and i + D/2, the rotation's
//   pair) and loads and stores them whole. Vectors are 16 bytes (8 bf16);
//   for D = 24 the halves are 12 elements, 24 bytes apart, and the vectors
//   are 8 bytes (4 bf16). Rows are visited in the destination's order so
//   that the writes stream; every read is a whole row of D elements.
// * vec: some move reads or writes the token-minor hdt layout, and
//   T % 8 == 0, so an hdt row is a whole number of 16-byte vectors. A
//   thread takes 8 tokens x one 4-element vector of each half of a row
//   (elements d0.. and d0 + D/2..) of one head: 16 vector loads, and where
//   the move rotates the rows' 16 cos/sin vectors, all in flight at once.
//   An hdt source is read as 4 columns of 8 tokens (16 bytes each) and
//   transposed in registers (one byte permute per output word), so the
//   rotation always runs on token-major rows with whole cos/sin vectors
//   from the tables, as in the rows kernel, and an hdt destination is
//   written the same way back. No shared memory: every global access is
//   a vector (8 bytes on a token-major side, 16 on an hdt side), and the
//   lanes of a warp fill whole 32-byte sectors (8 lanes over a row's
//   64-byte half at D = 64; 8 lanes over 64 tokens of an hdt row). A
//   token-major move in the same launch (split_t's q) takes the same walk
//   without the transposes. It replaces the tile kernel's rotation,
//   which read the pair partner and both table entries element by
//   element from shared memory (the tables 8 lanes to a bank). On an
//   NVIDIA H100 80GB HBM3 at 700 W (tools/sm90_ab.py headsplit_vec;
//   PERF.md), the rotating moves ran 13-23% slower with the tables
//   loaded after the data, and 2-6% slower with 8-element vectors (182
//   registers a thread).
// * tile: some move reads or writes hdt and T % 8 != 0 (launched by
//   name, it is also vec's yardstick at any T). A block takes 64
//   tokens x D of one head of one tensor into shared memory, reading
//   along the source's contiguous axis (D for thd and htd, T for hdt)
//   and writing along the destination's, 16 bytes per thread where
//   the alignment allows (T % 8 == 0 for hdt rows) and element by element
//   at a ragged last tile. Rows of the tile are padded by one 4-byte word
//   so that the column walks of the transposes spread over the banks.
//   The tile's cos/sin rows are staged beside it. The layout of each
//   tensor is uniform in a block, so one launch can move tensors of
//   different layout pairs (the TPU kernel's q to htd beside k and v to
//   hdt) at no cost to the others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

enum Layout { THD = 0, HTD = 1, HDT = 2 };
enum Rot { NONE = 0, ROT = 1, ROT_T = 2 };
// the kernel of a launch (headsplit.py:RELAYOUT_ROUTES' order)
enum Route { ROUTE_ROWS = 0, ROUTE_TILE = 1, ROUTE_VEC = 2 };

constexpr int MAX_MOVES = 3;
constexpr int TT = 64;  // tokens per tile
constexpr int VEC_T = 4;  // elements per row vector of the vec kernel
constexpr int THREADS = 256;

struct Move {
  const bf16* src;
  bf16* dst;
  int src_layout;
  int dst_layout;
  int rot;
};

struct Args {
  Move m[MAX_MOVES];
  const bf16* cos;
  const bf16* sin;
  int T;
  int H;
};

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One rotated element: x is element d of its row, p its partner d +- D/2;
// first half: x c - p s, second half: x c + p s (s already negated for
// R^T). Products rounded to bf16, the sum rounded once.
__device__ __forceinline__ bf16 rotate(float x, float p, float c, float s,
                                       bool first_half) {
  const float a = rnd(x * c), b = rnd(p * s);
  return __float2bfloat16(first_half ? a - b : a + b);
}

// The move of tensor z, read field by field from the kernel's parameters:
// indexing a.m[z] with a value known only at run time would copy all of
// Args to each thread's local memory first.
__device__ __forceinline__ Move move(const Args& a, unsigned z) {
  return z == 0 ? a.m[0] : z == 1 ? a.m[1] : a.m[2];
}

// Offset of element (t, h, d) in a layout.
template <int D>
__device__ __forceinline__ int64_t offset(int layout, int64_t t, int h, int d,
                                          int T, int H) {
  if (layout == THD) return (t * H + h) * D + d;
  if (layout == HTD) return ((int64_t)h * T + t) * D + d;
  return ((int64_t)h * D + d) * T + t;
}

template <int VEC>
struct Raw;
template <>
struct Raw<8> {
  typedef uint4 type;
};
template <>
struct Raw<4> {
  typedef uint2 type;
};

// ---------------------------------------------------------------- rows --

template <int D, int VEC>
__global__ void __launch_bounds__(THREADS) relayout_rows_kernel(Args a) {
  constexpr int H2 = D / 2;
  constexpr int NV = H2 / VEC;  // vectors per half row
  typedef typename Raw<VEC>::type raw_t;
  const Move mv = move(a, blockIdx.y);
  const int T = a.T, H = a.H;
  const int64_t n = (int64_t)T * H * NV;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const bool by_token = mv.dst_layout == THD;
  const bool inverse = mv.rot == ROT_T;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int d = (int)(i % NV) * VEC;
    const int64_t r = i / NV;
    const int64_t t = by_token ? r / H : r % T;
    const int h = (int)(by_token ? r % H : r / T);
    const bf16* x = mv.src + offset<D>(mv.src_layout, t, h, d, T, H);
    bf16* y = mv.dst + offset<D>(mv.dst_layout, t, h, d, T, H);
    raw_t r1 = *reinterpret_cast<const raw_t*>(x);
    raw_t r2 = *reinterpret_cast<const raw_t*>(x + H2);
    if (mv.rot != NONE) {
      const raw_t rc = *reinterpret_cast<const raw_t*>(a.cos + t * D + d);
      const raw_t rs = *reinterpret_cast<const raw_t*>(a.sin + t * D + d);
      const bf16* x1 = reinterpret_cast<const bf16*>(&r1);
      const bf16* x2 = reinterpret_cast<const bf16*>(&r2);
      const bf16* c = reinterpret_cast<const bf16*>(&rc);
      const bf16* s = reinterpret_cast<const bf16*>(&rs);
      raw_t o1, o2;
      bf16* y1 = reinterpret_cast<bf16*>(&o1);
      bf16* y2 = reinterpret_cast<bf16*>(&o2);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f1 = __bfloat162float(x1[j]), f2 = __bfloat162float(x2[j]);
        const float fc = __bfloat162float(c[j]);
        const float fs = inverse ? -__bfloat162float(s[j])
                                 : __bfloat162float(s[j]);
        y1[j] = rotate(f1, f2, fc, fs, true);
        y2[j] = rotate(f2, f1, fc, fs, false);
      }
      r1 = o1;
      r2 = o2;
    }
    *reinterpret_cast<raw_t*>(y) = r1;
    *reinterpret_cast<raw_t*>(y + H2) = r2;
  }
}

// ---------------------------------------------------------------- tile --

template <int D>
__global__ void __launch_bounds__(THREADS) relayout_tile_kernel(Args a) {
  constexpr int H2 = D / 2;
  constexpr int LD = D + 2;  // row pitch in bf16: one 4-byte word of pad
  constexpr int CH = D / 8;  // 16-byte chunks per row of D
  __shared__ bf16 tile[TT * LD];
  __shared__ bf16 ctab[TT * H2];
  __shared__ bf16 stab[TT * H2];
  const Move mv = move(a, blockIdx.z);
  const int T = a.T, H = a.H;
  const int h = blockIdx.y;
  const int64_t t0 = (int64_t)blockIdx.x * TT;
  const int64_t left = T - t0;
  const int nt = left < TT ? (int)left : TT;
  const bool vec_t = T % 8 == 0;  // 16-byte aligned rows of hdt

  if (mv.src_layout == HDT) {
    const bf16* base = mv.src + (int64_t)h * D * T + t0;
    for (int i = threadIdx.x; i < D * (TT / 8); i += THREADS) {
      const int d = i / (TT / 8), c = (i % (TT / 8)) * 8;
      const bf16* p = base + (int64_t)d * T + c;
      if (vec_t && c + 8 <= nt) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) tile[(c + j) * LD + d] = e[j];
      } else {
        for (int j = 0; j < 8 && c + j < nt; ++j) tile[(c + j) * LD + d] = p[j];
      }
    }
  } else {
    for (int i = threadIdx.x; i < TT * CH; i += THREADS) {
      const int t = i / CH, c = (i % CH) * 8;
      if (t >= nt) continue;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          mv.src + offset<D>(mv.src_layout, t0 + t, h, c, T, H));
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) tile[t * LD + c + j] = e[j];
    }
  }
  if (mv.rot != NONE) {
    for (int i = threadIdx.x; i < TT * H2; i += THREADS) {
      const int t = i / H2, d = i % H2;
      if (t < nt) {
        ctab[i] = a.cos[(t0 + t) * D + d];
        stab[i] = a.sin[(t0 + t) * D + d];
      }
    }
  }
  __syncthreads();

  const int rot = mv.rot;
  auto elem = [&](int t, int d) -> bf16 {
    const bf16 x = tile[t * LD + d];
    if (rot == NONE) return x;
    const bool first = d < H2;
    const int dd = first ? d : d - H2;
    const float p = __bfloat162float(tile[t * LD + (first ? d + H2 : dd)]);
    const float c = __bfloat162float(ctab[t * H2 + dd]);
    const float s = __bfloat162float(stab[t * H2 + dd]);
    return rotate(__bfloat162float(x), p, c, rot == ROT_T ? -s : s, first);
  };

  if (mv.dst_layout == HDT) {
    bf16* base = mv.dst + (int64_t)h * D * T + t0;
    for (int i = threadIdx.x; i < D * (TT / 8); i += THREADS) {
      const int d = i / (TT / 8), c = (i % (TT / 8)) * 8;
      bf16* p = base + (int64_t)d * T + c;
      if (vec_t && c + 8 <= nt) {
        uint4 raw;
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = elem(c + j, d);
        *reinterpret_cast<uint4*>(p) = raw;
      } else {
        for (int j = 0; j < 8 && c + j < nt; ++j) p[j] = elem(c + j, d);
      }
    }
  } else {
    for (int i = threadIdx.x; i < TT * CH; i += THREADS) {
      const int t = i / CH, c = (i % CH) * 8;
      if (t >= nt) continue;
      uint4 raw;
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = elem(t, c + j);
      *reinterpret_cast<uint4*>(
          mv.dst + offset<D>(mv.dst_layout, t0 + t, h, c, T, H)) = raw;
    }
  }
}

// ----------------------------------------------------------------- vec --

// VEC bf16 of a row, as 32-bit words (element e in the low half of word
// e / 2 when e is even)
template <int VEC>
struct Vec {
  uint32_t w[VEC / 2];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const bf16* p) {
  Vec<VEC> v;
  if constexpr (VEC == 8) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    v.w[0] = r.x, v.w[1] = r.y, v.w[2] = r.z, v.w[3] = r.w;
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    v.w[0] = r.x, v.w[1] = r.y;
  }
  return v;
}

template <int VEC>
__device__ __forceinline__ void store_vec(bf16* p, const Vec<VEC>& v) {
  if constexpr (VEC == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
}

// ROWS vectors of COLS elements -> COLS vectors of ROWS elements: word k
// of output c is element c of input rows 2k and 2k + 1
template <int ROWS, int COLS>
__device__ __forceinline__ void transpose(const Vec<COLS> (&in)[ROWS],
                                          Vec<ROWS> (&out)[COLS]) {
#pragma unroll
  for (int c = 0; c < COLS; ++c)
#pragma unroll
    for (int k = 0; k < ROWS / 2; ++k)
      out[c].w[k] = __byte_perm(in[2 * k].w[c / 2], in[2 * k + 1].w[c / 2],
                                c % 2 ? 0x7632 : 0x5410);
}

// element e of v as a float (bf16 widens exactly)
template <int VEC>
__device__ __forceinline__ float elem_f(const Vec<VEC>& v, int e) {
  const uint32_t w = v.w[e / 2];
  return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The rotation of one token's pair of vectors, x1 from the first half of
// the row and x2 its partners D/2 further, with the tables' vectors c, s
// (s negated for R^T): rotate() element by element, as the rows kernel.
template <int VEC>
__device__ __forceinline__ void rotate_vec(Vec<VEC>& x1, Vec<VEC>& x2,
                                           const Vec<VEC>& c,
                                           const Vec<VEC>& s, bool inverse) {
  Vec<VEC> y1, y2;
#pragma unroll
  for (int e = 0; e < VEC; e += 2) {
    bf16 o1[2], o2[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float f1 = elem_f(x1, e + k), f2 = elem_f(x2, e + k);
      const float fc = elem_f(c, e + k);
      const float fs = inverse ? -elem_f(s, e + k) : elem_f(s, e + k);
      o1[k] = rotate(f1, f2, fc, fs, true);
      o2[k] = rotate(f2, f1, fc, fs, false);
    }
    y1.w[e / 2] = pack2(o1[0], o1[1]);
    y2.w[e / 2] = pack2(o2[0], o2[1]);
  }
  x1 = y1;
  x2 = y2;
}

template <int D>
__global__ void __launch_bounds__(THREADS) relayout_vec_kernel(Args a) {
  constexpr int VEC = VEC_T;
  constexpr int H2 = D / 2;
  constexpr int NP = H2 / VEC;  // vector pairs per row
  constexpr int TV = 8;         // tokens per thread: one 16-byte hdt vector
  const Move mv = move(a, blockIdx.y);
  const int T = a.T, H = a.H;
  const int NT = T / TV;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)NT * H * NP) return;
  // lanes run over the vector pairs of a row, then over token groups
  const int d0 = (int)(i % NP) * VEC;
  const int64_t r = i / NP;
  const int64_t t0 = (r % NT) * TV;
  const int h = (int)(r / NT);

  // the rows' cos and sin vectors, in flight beside the data (issued
  // after it, they would add a second round trip to every thread)
  Vec<VEC> cs[2][TV];
  if (mv.rot != NONE) {
#pragma unroll
    for (int j = 0; j < TV; ++j) {
      const int64_t row = (t0 + j) * D + d0;
      cs[0][j] = load_vec<VEC>(a.cos + row);
      cs[1][j] = load_vec<VEC>(a.sin + row);
    }
  }
  Vec<VEC> x[2][TV];  // token-major: x[half][j] = row t0 + j, d0 + half H2..
  if (mv.src_layout == HDT) {
    const bf16* base = mv.src + (int64_t)h * D * T + t0;
    Vec<TV> col[2][VEC];  // col[half][e] = tokens t0.. of d = d0 + half H2 + e
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        col[half][e] = load_vec<TV>(base + (int64_t)(half * H2 + d0 + e) * T);
#pragma unroll
    for (int half = 0; half < 2; ++half) transpose(col[half], x[half]);
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < TV; ++j)
        x[half][j] = load_vec<VEC>(mv.src + offset<D>(mv.src_layout, t0 + j,
                                                      h, half * H2 + d0, T,
                                                      H));
  }
  if (mv.rot != NONE) {
    const bool inverse = mv.rot == ROT_T;
#pragma unroll
    for (int j = 0; j < TV; ++j)
      rotate_vec(x[0][j], x[1][j], cs[0][j], cs[1][j], inverse);
  }
  if (mv.dst_layout == HDT) {
    bf16* base = mv.dst + (int64_t)h * D * T + t0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      Vec<TV> col[VEC];
      transpose(x[half], col);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store_vec(base + (int64_t)(half * H2 + d0 + e) * T, col[e]);
    }
  } else {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < TV; ++j)
        store_vec(
            mv.dst + offset<D>(mv.dst_layout, t0 + j, h, half * H2 + d0, T, H),
            x[half][j]);
  }
}

// ------------------------------------------------------------- launch --

template <int D>
cudaError_t launch(const Args& a, int n, int route, cudaStream_t stream) {
  constexpr int VEC = (D / 2) % 8 == 0 ? 8 : 4;
  if (route == ROUTE_ROWS) {
    const int64_t work = (int64_t)a.T * a.H * (D / 2 / VEC);
    int64_t blocks = (work + THREADS - 1) / THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond that
    if (blocks < 1) blocks = 1;
    relayout_rows_kernel<D, VEC>
        <<<dim3((unsigned)blocks, n), THREADS, 0, stream>>>(a);
  } else if (route == ROUTE_VEC) {
    const int64_t work = (int64_t)(a.T / 8) * a.H * (D / 2 / VEC_T);
    relayout_vec_kernel<D>
        <<<dim3((unsigned)((work + THREADS - 1) / THREADS), n), THREADS, 0,
           stream>>>(a);
  } else {
    relayout_tile_kernel<D>
        <<<dim3((unsigned)((a.T + TT - 1) / TT), a.H, n), THREADS, 0,
           stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Moves n (1 to 3) tensors src[i] -> dst[i]; spec[i] packs the source
// layout (bits 0-1), the destination layout (bits 2-3) and the rotation
// (bits 4-5) of tensor i. cos and sin may be null when nothing rotates.
// route (enum Route) names the kernel: rows only where no move has an hdt
// side, vec only where T % 8 == 0, tile anywhere. Returns the cudaError_t
// of the launch (0 on success).
int esme_relayout_heads(const void* x0, const void* x1, const void* x2,
                        void* y0, void* y1, void* y2, int spec0, int spec1,
                        int spec2, int n, const void* cos, const void* sin,
                        int T, int H, int D, int route, void* stream) {
  if (n < 1 || n > MAX_MOVES || T < 1 || H < 1 || H > 65535 ||
      route < ROUTE_ROWS || route > ROUTE_VEC ||
      (route == ROUTE_VEC && T % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const void* xs[MAX_MOVES] = {x0, x1, x2};
  void* ys[MAX_MOVES] = {y0, y1, y2};
  const int specs[MAX_MOVES] = {spec0, spec1, spec2};
  Args a = {};
  bool rows = true;
  for (int i = 0; i < n; ++i) {
    Move& m = a.m[i];
    m.src = static_cast<const bf16*>(xs[i]);
    m.dst = static_cast<bf16*>(ys[i]);
    m.src_layout = specs[i] & 3;
    m.dst_layout = (specs[i] >> 2) & 3;
    m.rot = (specs[i] >> 4) & 3;
    if (m.src_layout > HDT || m.dst_layout > HDT || m.rot > ROT_T ||
        (m.rot != NONE && (cos == nullptr || sin == nullptr)))
      return (int)cudaErrorInvalidValue;
    rows = rows && m.src_layout != HDT && m.dst_layout != HDT;
  }
  if (route == ROUTE_ROWS && !rows) return (int)cudaErrorInvalidValue;
  a.cos = static_cast<const bf16*>(cos);
  a.sin = static_cast<const bf16*>(sin);
  a.T = T;
  a.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return (int)launch<16>(a, n, route, st);
    case 24: return (int)launch<24>(a, n, route, st);
    case 32: return (int)launch<32>(a, n, route, st);
    case 64: return (int)launch<64>(a, n, route, st);
    case 128: return (int)launch<128>(a, n, route, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* esme_relayout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
