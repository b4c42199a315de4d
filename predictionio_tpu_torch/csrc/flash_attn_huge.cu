// Exact attention for head dims above 1024 on Hopper (sm_90a): the forward
// O = softmax(Q K^T * s) V with its logsumexp, and the backward's dK/dV and
// dQ, with no ceiling on the head dim.
//
// Replaces no TPU kernel. The JAX package answers these head dims with its
// plain blockwise_attention (predictionio_tpu/parallel/ring_attention.py::
// flash_attention sends every shape but D 64 and 128 there), so on a TPU
// they never reach a Pallas kernel. The port's rule is that a wrapper
// launches its kernel or raises on a CUDA tensor, never the plain version;
// these kernels are what the wrappers in ops/kernels.py launch for
// D > 1024, where flash_attn_wide.cu stops (its cluster of at most 8 CTAs
// holds 1024 features). Same function as the plain versions in
// parallel/ring_attention.py (blockwise_attention, blockwise_attention_bwd)
// and as the wide kernels: q, k, v, do [B, L, H, D] (f32 or bf16, row-major,
// contiguous), the scale s of the caller's original head dim, an optional
// causal mask (key j visible to query i iff j <= i), f32 running max, sum
// and accumulators, outputs in the input dtype. With bf16 inputs every
// product is exact in f32; P is rounded to bf16 before P V and dV, and dS
// before dK and dQ, as the plain version rounds them; the row sum and dS
// use the unrounded P. With f32 inputs everything stays f32 on CUDA-core
// FFMAs: no TF32, no tensor cores.
//
// D here is a multiple of 128 above 1024 (the caller zero-pads the head dim
// up to one, which is exact).
//
// What bounds it on the card: operations, as for the wide kernels (4*D FLOP
// per visible pair forward, 8*D for dK/dV, 6*D for dQ), at the f32 FFMA
// peak for f32 and at the bf16 tensor-core peak for bf16.
//
// The forward (huge_fwd) is a first version, simple and far from that
// bound: a CTA of 256 threads owns kRows = 4 neighbouring query rows of one
// (batch, head); thread t owns the features t, t + 256, ... of every row.
// Keys stream by in tiles of kKeys = 8: a thread forms its partial dot
// products over its features for the 4 x 8 pairs, the partials are summed
// across the CTA (a butterfly of xor shuffles in each warp, then the 8
// warps' sums in warp order, through shared memory), and the f32
// accumulator O lives in a workspace in global memory that the wrapper
// allocates, [CTA][row][D], rescaled in place by each tile's change of the
// running max; causal CTAs stop at the diagonal.
//
// The backward splits in two passes, each an ordinary tiled product with
// no cross-CTA sum. At these widths the score matrix is cheap beside the
// contractions over D: a visible pair costs 8*D >= 9,216 FLOP in dK/dV
// and its P and dS 8 bytes in f32.
// - The score pass (huge_score, both entry points): one CTA of 256 threads
//   per (batch, head, 64-row own tile, 64-row other tile) that the mask
//   leaves visible. It forms S and dP of the 64 x 64 tile over all of D, D
//   in chunks of 32 (f32) or 64 (bf16) features in increasing order,
//   through a two-stage cp.async ring of the four row tiles (own Q or K,
//   own dO or V, the other side's). Warps 0-3 form S, warps 4-7 dP, so a
//   thread holds one tile's sums. f32: register tiles, each thread 8 own
//   rows x 4 other rows, 16-byte shared loads along the features (12 loads
//   for 128 FFMAs a 4-feature step); bf16: mma.sync m16n8k16 fed by
//   ldmatrix, a warp 16 own rows x 64 (three CTAs an SM, two for f32).
//   The tiles meet in shared memory for the epilogue: P = exp2(S * s *
//   log2(e) - lse * log2(e)), exact zeros past L and above the diagonal,
//   dS = (dP - di) * P * s from the unrounded P, both rounded to bf16 for
//   bf16 inputs, written to a workspace in the input type, one 64 x 64
//   tile a pair, laid out as the product pass reads its operand:
//   [key][query] (P^T, then dS^T) for dK/dV, [query][key] (dS) for dQ.
// - The product pass (huge_product): one CTA per (batch, head, 64-row own
//   tile, 128-feature slice of D), 128 threads an output (dK/dV: dV = P^T
//   dO and dK = dS^T Q, 256 threads; dQ: dQ = dS K, 128). The other side's
//   visible tiles are summed in increasing position through a two-stage
//   cp.async ring of the workspace tile and the 64 x 128 slice of dO, Q or
//   K. f32: each thread 8 own rows x 8 features (16 shared loads for 256
//   FFMAs a 4-row step); bf16: mma.sync, a warp 16 own rows x 128. The
//   sums stay in registers and are written once, in the input type.
// - Bands: the workspace holds at most 256 MiB (kWsCap). dK/dV bands over
//   own key tiles and dQ over own query tiles, so every gradient row is
//   complete in one band: no sum across bands, no atomics. A band is the
//   most own tiles of all (batch, head)s that fit the cap (one tile of a
//   group of (batch, head)s where even one tile of every head does not),
//   the score pass and then the product pass for each, in order on the
//   caller's stream; under a causal mask each band takes its heaviest own
//   tiles first (dK/dV's first key tiles, dQ's last query tiles), and so do
//   the bands. ops/kernels.py::huge_bwd_plan is the same plan in Python;
//   pio_flash_attn_huge_bwd_plan reports it from the card.
// What the split does about the first version's faults: a streamed feature
// serves 64 rows of a tile (not 4); every load is a 16-byte cp.async into
// shared memory (not a scalar global load); no score is a block reduction;
// no accumulator lives in global memory (the workspace holds P and dS,
// written once and read once a feature slice); and the bf16 kernels use
// the tensor cores. The price is S and dP formed by both entry points, as
// before, and P and dS through the L2 (one f32 [L, L] plane at L 1024 is
// 4 MiB).
//
// Determinism: no atomics; every sum runs in one fixed order (features in
// increasing order, inside an mma its own fixed order; the other side's
// tiles and rows in increasing position; the forward's butterfly and warps
// in order), so two runs give the same bits.
//
// Softmax: the running max m is kept in log2 units, S * s * log2(e). The
// logsumexp is written in natural-log units, m ln(2) + log(l), as the other
// kernels write it, and the backward rebuilds P = exp2(S * s * log2(e) -
// lse * log2(e)) from it.

#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows a CTA owns
constexpr int kKeys = 8;  // other-side rows a tile
constexpr int kPairs = kRows * kKeys;

__device__ __forceinline__ float load(float x) { return x; }
__device__ __forceinline__ float load(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T store(float x);
template <>
__device__ __forceinline__ float store<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 store<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x as the product's operand: rounded to bf16 for bf16 inputs (as the plain
// version rounds P and dS), unchanged for f32
template <typename T>
__device__ __forceinline__ float operand(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float operand<float>(float x) {
  return x;
}

// the forward's arguments
struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out0;  // o
  float* lse_out;
  float* ws;   // f32 accumulators: [CTA][kRows][D]
  int B, L, H, D, causal;
  float scale;
  cudaStream_t stream;
};

// element offset of row `pos` of (b, h) in a [B, L, H, D] tensor
__device__ __forceinline__ size_t row_off(int b, int pos, int h, int L,
                                          int H, int D) {
  return (((size_t)b * L + pos) * H + h) * (size_t)D;
}

// the CTA's workspace: n blocks of kRows rows of D floats
__device__ __forceinline__ float* cta_ws(const Args& a, int n) {
  const size_t cta =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  return a.ws + cta * (size_t)n * kRows * a.D;
}

// Sum the N partials of every thread across the CTA, in a fixed order:
// a butterfly in each warp, then the warps in order. Every thread returns
// with all N sums in x. red holds kWarps * N floats, tot N.
template <int N>
__device__ __forceinline__ void block_sum(float (&x)[N], float* red,
                                          float* tot) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x[n] += __shfl_xor_sync(0xffffffffu, x[n], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[warp * N + n] = x[n];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * N + n];
    tot[n] = s;
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) x[n] = tot[n];
  __syncthreads();  // red and tot are free for the next tile
}

// ---------------------------------------------------------------------------
// forward: kRows query rows a CTA, keys streamed kKeys at a time

template <typename T>
__global__ void __launch_bounds__(kThreads) huge_fwd(const Args a) {
  __shared__ float red[kWarps * kPairs];
  __shared__ float tot[kPairs];
  const int h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, H = a.H, D = a.D;
  const int r0 = blockIdx.x * kRows;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  float* ws = cta_ws(a, 1);
  const float c = a.scale * kLog2e;

  for (int i = 0; i < kRows; ++i)
    for (int d = threadIdx.x; d < D; d += kThreads) ws[i * D + d] = 0.f;
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const int last = min(L - 1, r0 + kRows - 1);
  const int kend = a.causal ? last + 1 : L;
  for (int k0 = 0; k0 < kend; k0 += kKeys) {
    float s[kPairs];
#pragma unroll
    for (int n = 0; n < kPairs; ++n) s[n] = 0.f;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float kv[kKeys];
#pragma unroll
      for (int r = 0; r < kKeys; ++r)
        kv[r] = k0 + r < L ? load(k[row_off(b, k0 + r, h, L, H, D) + d]) : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float qv =
            r0 + i < L ? load(q[row_off(b, r0 + i, h, L, H, D) + d]) : 0.f;
#pragma unroll
        for (int r = 0; r < kKeys; ++r)
          s[i * kKeys + r] = fmaf(qv, kv[r], s[i * kKeys + r]);
      }
    }
    block_sum<kPairs>(s, red, tot);
    float alpha[kRows], p[kPairs];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = r0 + i;
      float tmax = -INFINITY;
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const int kpos = k0 + r;
        const bool seen = row < L && kpos < L && (!a.causal || kpos <= row);
        s[i * kKeys + r] = seen ? s[i * kKeys + r] * c : -INFINITY;
        tmax = fmaxf(tmax, s[i * kKeys + r]);
      }
      if (tmax == -INFINITY) {  // no key of this tile is visible to the row
        alpha[i] = 1.f;
#pragma unroll
        for (int r = 0; r < kKeys; ++r) p[i * kKeys + r] = 0.f;
        continue;
      }
      const float m_new = fmaxf(m[i], tmax);
      alpha[i] = exp2f(m[i] - m_new);  // 0 on the first visible tile
      l[i] *= alpha[i];
#pragma unroll
      for (int r = 0; r < kKeys; ++r) {
        const float pr = exp2f(s[i * kKeys + r] - m_new);  // masked: 0
        l[i] += pr;
        p[i * kKeys + r] = operand<T>(pr);
      }
      m[i] = m_new;
    }
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float vv[kKeys];
#pragma unroll
      for (int r = 0; r < kKeys; ++r)
        vv[r] = k0 + r < L ? load(v[row_off(b, k0 + r, h, L, H, D) + d]) : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float acc = ws[i * D + d] * alpha[i];
#pragma unroll
        for (int r = 0; r < kKeys; ++r)
          acc = fmaf(p[i * kKeys + r], vv[r], acc);
        ws[i * D + d] = acc;
      }
    }
  }
  T* o = static_cast<T*>(a.out0);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r0 + i;
    if (row >= L) break;
    const float inv = 1.f / l[i];
    const size_t off = row_off(b, row, h, L, H, D);
    for (int d = threadIdx.x; d < D; d += kThreads)
      o[off + d] = store<T>(ws[i * D + d] * inv);
    if (a.lse_out != nullptr && threadIdx.x == 0)
      a.lse_out[((size_t)b * H + h) * L + row] = m[i] * kLn2 + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// backward: a score pass into a banded workspace, then a product pass

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

constexpr int kTile = 64;  // rows of a score tile on each side
constexpr int kTileElems = kTile * kTile;
constexpr int kOut = 128;  // features of a product CTA's slice
constexpr int kScoreThreads = 256;
constexpr int kGroup = 128;  // threads of one product output
constexpr int kBwdStages = 2;
constexpr int kSB = kTile + 4;  // row stride of the epilogue's f32 tiles
constexpr long long kWsCap = 256ll << 20;  // workspace bytes, at most

// features of a score-pass chunk: 32 f32, 64 bf16 (128 bytes a row)
template <typename T>
__host__ __device__ constexpr int chunk() {
  return 128 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int score_smem() {
  return kBwdStages * 4 * kTile * row_stride<T, chunk<T>()>() * (int)sizeof(T);
}

// an output's workspace tile [64][SA] and other-side slice [64][SY] a stage
template <typename T>
__host__ __device__ constexpr int product_stage_elems() {
  return kTile * (row_stride<T, kTile>() + row_stride<T, kOut>());
}

template <typename T, int KIND>
__host__ __device__ constexpr int product_smem() {
  return kBwdStages * (KIND == kDkv ? 2 : 1) * product_stage_elems<T>() *
         (int)sizeof(T);
}

static_assert(score_smem<float>() >= 2 * kTile * kSB * 4 &&
                  score_smem<bf16>() >= 2 * kTile * kSB * 4,
              "the epilogue's S and dP tiles fit in the score ring");
static_assert(product_smem<float, kDkv>() <= 232448 &&
                  score_smem<float>() <= 232448,
              "a CTA's shared memory");

struct Bwd {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void* out0;  // dk (dK/dV), dq (dQ)
  void* out1;  // dv (dK/dV)
  void* ws;    // one band's P and dS tiles, in the input type
  int B, L, H, D, causal;
  float scale;
  cudaStream_t stream;
};

// One band: (batch, head)s [bh0, bh0 + nbh) (b * H + h), own tiles [t0,
// t0 + tiles) of nt a sequence. Workspace tile of (head bh0 + y, own tile
// t, other tile o): ((y * tiles + t - t0) * nt + o) * planes tiles.
struct Band {
  int bh0, nbh, t0, tiles, nt;
};

// the other side's tiles that own tile t sees: dK/dV owns key tiles and,
// under a causal mask, sees the query tiles from its own on; dQ owns query
// tiles and sees the key tiles up to its own
__host__ __device__ inline int seen_tiles(int kind, bool causal, int t,
                                          int nt) {
  return !causal ? nt : kind == kDkv ? nt - t : t + 1;
}
__host__ __device__ inline int first_seen(int kind, bool causal, int t) {
  return causal && kind == kDkv ? t : 0;
}

// f32 S or dP of a 64 x 64 tile, one 32-feature chunk: this thread's 8 own
// rows og + 8 i by 4 other rows oc + 16 j of the 128 threads on the tile;
// X own rows, Y other rows, [row][36], features in increasing order
__device__ __forceinline__ void score_chunk(float (&acc)[8][4],
                                            const float* X, const float* Y) {
  constexpr int SC = row_stride<float, chunk<float>()>();
  const int lt = threadIdx.x & 127, ln = lt & 31;
  const int og = 2 * (lt >> 5) + (ln >> 4), oc = ln & 15;
#pragma unroll
  for (int d = 0; d < chunk<float>(); d += 4) {
    float4 y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y[j] = *reinterpret_cast<const float4*>(&Y[(oc + 16 * j) * SC + d]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(&X[(og + 8 * i) * SC + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(x.x, y[j].x, s);
        s = fmaf(x.y, y[j].y, s);
        s = fmaf(x.z, y[j].z, s);
        s = fmaf(x.w, y[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// bf16: this warp's 16 own rows by the 64 other rows (8 n-tiles), one
// 64-feature chunk, [row][72]
__device__ __forceinline__ void score_chunk(float (&acc)[8][4],
                                            const bf16* X, const bf16* Y) {
  mma_rows<chunk<bf16>(), 8>(acc, X, Y, 16 * ((threadIdx.x >> 5) & 3));
}

// a thread's S or dP sums to the [own][kSB] f32 tile P
__device__ __forceinline__ void put_acc(float* P, const float (&acc)[8][4],
                                        float) {
  const int lt = threadIdx.x & 127, ln = lt & 31;
  const int og = 2 * (lt >> 5) + (ln >> 4), oc = ln & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      P[(og + 8 * i) * kSB + oc + 16 * j] = acc[i][j];
}
__device__ __forceinline__ void put_acc(float* P, const float (&acc)[8][4],
                                        bf16) {
  const int r0 = 16 * ((threadIdx.x >> 5) & 3), g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<float2*>(
          &P[(r0 + g + 8 * half) * kSB + 8 * n + 2 * t]) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
}

// four neighbouring workspace values, in the input type (bf16: rounded to
// nearest even)
__device__ __forceinline__ void put4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void put4(bf16* p, const float (&x)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
}

// Score CTAs an SM: f32 2 (128 registers; at 3, 80 registers spill and
// the pass is slower), bf16 3 (all of a 272-CTA pass resident, and more
// loads in flight: the bf16 pass waits on them)
template <typename T>
__host__ __device__ constexpr int score_ctas_an_sm() {
  return sizeof(T) == 4 ? 2 : 3;
}

template <typename T, int KIND, bool CAUSAL>
__global__ void __launch_bounds__(kScoreThreads, score_ctas_an_sm<T>())
    huge_score(const Bwd a, const Band band) {
  constexpr int CH = chunk<T>(), SC = row_stride<T, CH>();
  extern __shared__ __align__(16) unsigned char smem[];
  // [stage][own S operand, other S operand, own dP operand, other dP
  // operand][row][SC]
  T* ring = reinterpret_cast<T*>(smem);
  __shared__ float lse_s[kTile], di_s[kTile];  // the tile's query rows
  const int L = a.L, H = a.H, D = a.D;

  // the tile pair: blockIdx.x counts the visible pairs of the band's own
  // tiles in order
  const int bh = band.bh0 + blockIdx.y, b = bh / H, h = bh % H;
  int t = band.t0, rem = blockIdx.x;
  for (int n; rem >= (n = seen_tiles(KIND, CAUSAL, t, band.nt)); ++t)
    rem -= n;
  const int o = first_seen(KIND, CAUSAL, t) + rem;
  const int own_r0 = t * kTile, oth_r0 = o * kTile;

  const long long rs = (long long)H * D;
  const long long base = ((long long)b * L * H + h) * D;
  const long long rbase = ((long long)b * H + h) * L;
  // dK/dV: S^T = K Q^T, dP^T = V dO^T; dQ: S = Q K^T, dP = dO V^T
  const T* own0 = static_cast<const T*>(KIND == kDkv ? a.k : a.q);
  const T* oth0 = static_cast<const T*>(KIND == kDkv ? a.q : a.k);
  const T* own1 = static_cast<const T*>(KIND == kDkv ? a.v : a.dout);
  const T* oth1 = static_cast<const T*>(KIND == kDkv ? a.dout : a.v);

  auto load_chunk = [&](int c, int st) {
    T* s = ring + st * 4 * kTile * SC;
    const long long off = base + (long long)c * CH;
    stage_rows<T, CH, kTile, kScoreThreads>(s, own0, off, rs, own_r0, L, CH);
    stage_rows<T, CH, kTile, kScoreThreads>(s + kTile * SC, oth0, off, rs,
                                            oth_r0, L, CH);
    stage_rows<T, CH, kTile, kScoreThreads>(s + 2 * kTile * SC, own1, off,
                                            rs, own_r0, L, CH);
    stage_rows<T, CH, kTile, kScoreThreads>(s + 3 * kTile * SC, oth1, off,
                                            rs, oth_r0, L, CH);
    cp_async_commit();
  };
  const int q_r0 = KIND == kDkv ? oth_r0 : own_r0;
  stage_vec<kTile, kScoreThreads>(lse_s, a.lse, rbase, q_r0, L);
  stage_vec<kTile, kScoreThreads>(di_s, a.di, rbase, q_r0, L);
  load_chunk(0, 0);  // lse and di travel in the first group

  const int half = threadIdx.x / 128;  // 0: S, 1: dP
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int chunks = D / CH;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; stage c + 1 (c - 1's) is free
    if (c + 1 < chunks) load_chunk(c + 1, (c + 1) % kBwdStages);
    const T* X = ring + ((c % kBwdStages) * 4 + 2 * half) * kTile * SC;
    score_chunk(acc, X, X + kTile * SC);
  }
  __syncthreads();  // every chunk read: the ring holds the S and dP tiles
  float* Sb = reinterpret_cast<float*>(smem);  // [own][kSB], then dP
  put_acc(Sb + half * kTile * kSB, acc, T());
  __syncthreads();

  const float scale = a.scale, scale2 = a.scale * kLog2e;
  constexpr int planes = KIND == kDkv ? 2 : 1;
  T* ws = static_cast<T*>(a.ws) +
          (((long long)blockIdx.y * band.tiles + (t - band.t0)) * band.nt +
           o) * planes * kTileElems;
  for (int idx = threadIdx.x; idx < kTileElems / 4; idx += kScoreThreads) {
    const int r = idx / (kTile / 4), c = (idx % (kTile / 4)) * 4;
    const float4 s4 = *reinterpret_cast<const float4*>(&Sb[r * kSB + c]);
    const float4 d4 =
        *reinterpret_cast<const float4*>(&Sb[(kTile + r) * kSB + c]);
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int own = own_r0 + r, oth = oth_r0 + c + e;
      const int query = KIND == kDkv ? oth : own;
      const int key = KIND == kDkv ? own : oth;
      const int ql = KIND == kDkv ? c + e : r;  // in lse_s and di_s
      const bool seen = query < L && key < L && (!CAUSAL || key <= query);
      p[e] = seen ? exp_lse(lane4(s4, e), scale2, lse_s[ql]) : 0.f;
      ds[e] = seen ? (lane4(d4, e) - di_s[ql]) * p[e] * scale : 0.f;
    }
    if (KIND == kDkv) put4(ws + r * kTile + c, p);
    put4(ws + (planes - 1) * kTileElems + r * kTile + c, ds);
  }
}

// f32: this thread's 8 own rows rg + 8 i by the 8 features 4 cg + 64 c + e
// of the slice (acc[2 i + c][e]) += A Y over one 64-row other tile, rows in
// increasing order; A [own][68] (P^T, dS^T or dS), Y [other][132]
__device__ __forceinline__ void product_tile(float (&acc)[16][4],
                                             const float* A, const float* Y) {
  constexpr int SA = row_stride<float, kTile>();
  constexpr int SY = row_stride<float, kOut>();
  const int lt = threadIdx.x & 127, ln = lt & 31;
  const int rg = 2 * (lt >> 5) + (ln >> 4), cg = ln & 15;
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = *reinterpret_cast<const float4*>(&A[(rg + 8 * i) * SA + r]);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const float4 y0 =
          *reinterpret_cast<const float4*>(&Y[(r + rr) * SY + 4 * cg]);
      const float4 y1 =
          *reinterpret_cast<const float4*>(&Y[(r + rr) * SY + 64 + 4 * cg]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = lane4(x[i], rr);
        acc[2 * i][0] = fmaf(xv, y0.x, acc[2 * i][0]);
        acc[2 * i][1] = fmaf(xv, y0.y, acc[2 * i][1]);
        acc[2 * i][2] = fmaf(xv, y0.z, acc[2 * i][2]);
        acc[2 * i][3] = fmaf(xv, y0.w, acc[2 * i][3]);
        acc[2 * i + 1][0] = fmaf(xv, y1.x, acc[2 * i + 1][0]);
        acc[2 * i + 1][1] = fmaf(xv, y1.y, acc[2 * i + 1][1]);
        acc[2 * i + 1][2] = fmaf(xv, y1.z, acc[2 * i + 1][2]);
        acc[2 * i + 1][3] = fmaf(xv, y1.w, acc[2 * i + 1][3]);
      }
    }
  }
}

// bf16: this warp's 16 own rows by the slice's 128 features (16 n-tiles)
// += A Y over one other tile, four 16-row k-steps in order; A [own][72], Y
// [other][136]
__device__ __forceinline__ void product_tile(float (&acc)[16][4],
                                             const bf16* A, const bf16* Y) {
  constexpr int SA = row_stride<bf16, kTile>(), SY = row_stride<bf16, kOut>();
  const int r0 = 16 * ((threadIdx.x >> 5) & 3);
#pragma unroll
  for (int k0 = 0; k0 < kTile; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a_frag(A, SA, r0, k0));
#pragma unroll
    for (int f = 0; f < kOut / 8; f += 2) {
      uint32_t bb[4];
      ldsm_x4_t(bb, bt_frag(Y, SY, k0, f * 8));
      mma16816(acc[f], af, bb[0], bb[1]);
      mma16816(acc[f + 1], af, bb[2], bb[3]);
    }
  }
}

// the sums to out's rows [r0, r0 + 64) and the slice at `base`
__device__ __forceinline__ void write_out(float* __restrict__ out,
                                          const float (&acc)[16][4],
                                          long long base, long long rs,
                                          int r0, int L) {
  const int lt = threadIdx.x & 127, ln = lt & 31;
  const int rg = 2 * (lt >> 5) + (ln >> 4), cg = ln & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + rg + 8 * i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      *reinterpret_cast<float4*>(&out[base + row * rs + 4 * cg + 64 * c]) =
          make_float4(acc[2 * i + c][0], acc[2 * i + c][1],
                      acc[2 * i + c][2], acc[2 * i + c][3]);
  }
}
__device__ __forceinline__ void write_out(bf16* __restrict__ out,
                                          const float (&acc)[16][4],
                                          long long base, long long rs,
                                          int r0, int L) {
  write_bf16<kOut>(out, acc, base, rs, r0 + 16 * ((threadIdx.x >> 5) & 3),
                   L, kOut);
}

template <typename T, int KIND, bool CAUSAL>
__global__ void __launch_bounds__(KIND == kDkv ? 2 * kGroup : kGroup)
    huge_product(const Bwd a, const Band band) {
  constexpr int NOUT = KIND == kDkv ? 2 : 1, NT = NOUT * kGroup;
  constexpr int SA = row_stride<T, kTile>();
  constexpr int OUT_ELEMS = product_stage_elems<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  // [stage][output][workspace tile [64][SA], then the slice [64][SY]]
  T* ring = reinterpret_cast<T*>(smem);
  const int L = a.L, H = a.H, D = a.D;
  const int bh = band.bh0 + blockIdx.y, b = bh / H, h = bh % H;
  // heaviest first under a causal mask: dK/dV's first key tiles, dQ's last
  // query tiles
  const int z = blockIdx.z;
  const int t = KIND == kDkv ? band.t0 + z : band.t0 + band.tiles - 1 - z;
  const long long rs = (long long)H * D;
  const long long base =
      ((long long)b * L * H + h) * D + (long long)blockIdx.x * kOut;
  const T* ws = static_cast<const T*>(a.ws) +
                ((long long)blockIdx.y * band.tiles + (t - band.t0)) *
                    band.nt * NOUT * kTileElems;
  // dK/dV: dV = P^T dO, dK = dS^T Q; dQ: dQ = dS K
  const T* y0 = static_cast<const T*>(KIND == kDkv ? a.dout : a.k);
  const T* y1 = static_cast<const T*>(a.q);

  auto load_tile = [&](int o, int st) {
    T* s = ring + st * NOUT * OUT_ELEMS;
#pragma unroll
    for (int m = 0; m < NOUT; ++m) {
      stage_rows<T, kTile, kTile, NT>(s + m * OUT_ELEMS, ws,
                                      ((long long)o * NOUT + m) * kTileElems,
                                      kTile, 0, kTile, kTile);
      stage_rows<T, kOut, kTile, NT>(s + m * OUT_ELEMS + kTile * SA,
                                     m == 0 ? y0 : y1, base, rs, o * kTile, L,
                                     kOut);
    }
    cp_async_commit();
  };
  const int o0 = first_seen(KIND, CAUSAL, t);
  const int o1 = o0 + seen_tiles(KIND, CAUSAL, t, band.nt);
  load_tile(o0, 0);

  const int m = threadIdx.x / kGroup;  // this thread's output
  float acc[16][4];
#pragma unroll
  for (int f = 0; f < 16; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  for (int o = o0; o < o1; ++o) {
    const int it = o - o0;
    cp_async_wait_all();
    __syncthreads();  // tile o landed; stage it + 1 (it - 1's) is free
    if (o + 1 < o1) load_tile(o + 1, (it + 1) % kBwdStages);
    const T* s = ring + ((it % kBwdStages) * NOUT + m) * OUT_ELEMS;
    product_tile(acc, s, s + kTile * SA);
  }
  T* out = static_cast<T*>(KIND == kDkv && m == 0 ? a.out1 : a.out0);
  write_out(out, acc, base, rs, t * kTile, L);
}

// ---------------------------------------------------------------------------
// host side

bool shape_ok(int B, int L, int H, int D) {
  return B > 0 && L > 0 && H > 0 && B <= 65535 && H <= 65535 && D > 1024 &&
         D % 128 == 0;
}

template <typename T>
cudaError_t launch_fwd_t(const Args& a) {
  const dim3 grid((a.L + kRows - 1) / kRows, a.H, a.B);
  huge_fwd<T><<<grid, kThreads, 0, a.stream>>>(a);
  return cudaGetLastError();
}

int launch_fwd(const Args& a, int dtype) {
  if (!shape_ok(a.B, a.L, a.H, a.D) || a.ws == nullptr ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? launch_fwd_t<float>(a) : launch_fwd_t<bf16>(a));
}

// The backward's plan (ops/kernels.py::huge_bwd_plan): tiles and (batch,
// head)s a band, the bands, and the workspace bytes
struct Plan {
  int nt, tiles, heads;
  long long bh, bands, tile_bands, ws_bytes;
};

bool bwd_plan(int B, int L, int H, int D, int dtype, int kind, Plan* p) {
  if (!shape_ok(B, L, H, D) || (dtype != 0 && dtype != 1) ||
      (kind != kDq && kind != kDkv))
    return false;
  const long long pair =
      (long long)(kind == kDkv ? 2 : 1) * kTileElems * (dtype == 0 ? 4 : 2);
  const long long nt = (L + kTile - 1) / kTile, bh = (long long)B * H;
  const long long col = nt * pair;  // one own tile of one (batch, head)
  if (col > kWsCap) return false;
  const long long per = kWsCap / col;
  p->nt = (int)nt;
  p->bh = bh;
  if (per >= bh) {
    p->heads = (int)bh;
    p->tiles = (int)(per / bh < nt ? per / bh : nt);
  } else {
    p->heads = (int)per;
    p->tiles = 1;
  }
  p->tile_bands = (nt + p->tiles - 1) / p->tiles;
  p->bands = (bh + p->heads - 1) / p->heads * p->tile_bands;
  p->ws_bytes = (long long)p->heads * p->tiles * col;
  return true;
}

// band i in launch order: head groups in order, each its tile bands
// heaviest first (dK/dV from the first key tile, dQ from the last query
// tile)
Band band_of(const Plan& p, int kind, long long i) {
  const long long g = i / p.tile_bands, tb = i % p.tile_bands;
  Band band;
  band.bh0 = (int)(g * p.heads);
  band.nbh = (int)(p.bh - band.bh0 < p.heads ? p.bh - band.bh0 : p.heads);
  band.nt = p.nt;
  if (kind == kDkv) {
    band.t0 = (int)(tb * p.tiles);
    band.tiles = p.nt - band.t0 < p.tiles ? p.nt - band.t0 : p.tiles;
  } else {
    const int t1 = p.nt - (int)(tb * p.tiles);
    band.t0 = t1 > p.tiles ? t1 - p.tiles : 0;
    band.tiles = t1 - band.t0;
  }
  return band;
}

// the score pass's CTAs a (batch, head) of the band: its visible pairs
int score_ctas(const Band& band, int kind, bool causal) {
  int n = 0;
  for (int t = band.t0; t < band.t0 + band.tiles; ++t)
    n += seen_tiles(kind, causal, t, band.nt);
  return n;
}

template <typename T, int KIND, bool CAUSAL>
cudaError_t launch_bwd(const Bwd& a, const Plan& p) {
  for (long long i = 0; i < p.bands; ++i) {
    const Band band = band_of(p, KIND, i);
    huge_score<T, KIND, CAUSAL>
        <<<dim3(score_ctas(band, KIND, CAUSAL), band.nbh), kScoreThreads,
           score_smem<T>(), a.stream>>>(a, band);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    huge_product<T, KIND, CAUSAL>
        <<<dim3(a.D / kOut, band.nbh, band.tiles),
           KIND == kDkv ? 2 * kGroup : kGroup, product_smem<T, KIND>(),
           a.stream>>>(a, band);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// the backward's kernels: pass 0 score, 1 product
void* bwd_kernel(int dtype, int kind, bool causal, int pass) {
#define PIO_HUGE_PICK(T, K)                                              \
  (pass == 0 ? (causal ? (void*)huge_score<T, K, true>                   \
                       : (void*)huge_score<T, K, false>)                 \
             : (causal ? (void*)huge_product<T, K, true>                 \
                       : (void*)huge_product<T, K, false>))
  if (dtype == 0) return kind == kDkv ? PIO_HUGE_PICK(float, kDkv)
                                      : PIO_HUGE_PICK(float, kDq);
  return kind == kDkv ? PIO_HUGE_PICK(bf16, kDkv) : PIO_HUGE_PICK(bf16, kDq);
#undef PIO_HUGE_PICK
}

int bwd_smem(int dtype, int kind, int pass) {
  if (pass == 0) return dtype == 0 ? score_smem<float>() : score_smem<bf16>();
  if (dtype == 0)
    return kind == kDkv ? product_smem<float, kDkv>()
                        : product_smem<float, kDq>();
  return kind == kDkv ? product_smem<bf16, kDkv>() : product_smem<bf16, kDq>();
}

// Raise the dynamic shared-memory ceiling of the sixteen backward kernels,
// once a process
cudaError_t bwd_init() {
  static const cudaError_t err = [] {
    for (int dtype = 0; dtype < 2; ++dtype)
      for (int kind = kDq; kind <= kDkv; ++kind)
        for (int causal = 0; causal < 2; ++causal)
          for (int pass = 0; pass < 2; ++pass) {
            const cudaError_t e = cudaFuncSetAttribute(
                bwd_kernel(dtype, kind, causal, pass),
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                bwd_smem(dtype, kind, pass));
            if (e != cudaSuccess) return e;
          }
    return cudaSuccess;
  }();
  return err;
}

int launch_bwd_any(const Bwd& a, int dtype, int kind) {
  Plan p;
  if (!bwd_plan(a.B, a.L, a.H, a.D, dtype, kind, &p) || a.ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t init = bwd_init();
  if (init != cudaSuccess) return (int)init;
  cudaError_t err;
  if (dtype == 0) {
    if (kind == kDkv)
      err = a.causal ? launch_bwd<float, kDkv, true>(a, p)
                     : launch_bwd<float, kDkv, false>(a, p);
    else
      err = a.causal ? launch_bwd<float, kDq, true>(a, p)
                     : launch_bwd<float, kDq, false>(a, p);
  } else {
    if (kind == kDkv)
      err = a.causal ? launch_bwd<bf16, kDkv, true>(a, p)
                     : launch_bwd<bf16, kDkv, false>(a, p);
    else
      err = a.causal ? launch_bwd<bf16, kDq, true>(a, p)
                     : launch_bwd<bf16, kDq, false>(a, p);
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Bytes of workspace a call of `kind` (0 forward, 1 dQ, 2 dK/dV) with
// inputs of `dtype` (0 f32, 1 bf16) needs at [B, L, H, D]: the forward's
// f32 accumulators, or the backward's band of P and dS tiles in the input
// type (at most 256 MiB); -1 for a shape the kernels do not take.
long long pio_flash_attn_huge_workspace(int B, int L, int H, int D, int kind,
                                        int dtype) {
  if (kind == kFwd) {
    if (!shape_ok(B, L, H, D)) return -1;
    const long long ctas =
        (long long)((L + kRows - 1) / kRows) * (long long)H * (long long)B;
    return ctas * kRows * (long long)D * (long long)sizeof(float);
  }
  Plan p;
  return bwd_plan(B, L, H, D, dtype, kind, &p) ? p.ws_bytes : -1;
}

// q, k, v, o: [B, L, H, D] contiguous device buffers of one type (dtype 0 =
// f32, 1 = bf16); D a multiple of 128 above 1024; L >= 1, B and H <= 65535
// (the wrapper checks). lse: null, or a [B, H, L] f32 device buffer that
// receives each row's logsumexp. ws: pio_flash_attn_huge_workspace(...,
// 0, dtype) bytes of device memory. Launches on `stream`; returns the
// cudaError of the launch.
int pio_flash_attn_huge_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* ws, int B, int L, int H,
                            int D, int dtype, int causal, float scale,
                            void* stream) {
  const Args a{q, k, v, o, static_cast<float*>(lse), static_cast<float*>(ws),
               B, L, H, D, causal, scale, static_cast<cudaStream_t>(stream)};
  return launch_fwd(a, dtype);
}

// dk, dv of the forward for the output gradient do: q, k, v, do, dk, dv as
// above, 16-byte aligned; lse the forward's logsumexp and di = rowsum(do *
// o), [B, H, L] f32; ws of pio_flash_attn_huge_workspace(..., 2, dtype)
// bytes, 16-byte aligned. Launches the score and the product pass of every
// band on `stream`; returns the first cudaError.
int pio_flash_attn_huge_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dk, void* dv, void* ws,
                                int B, int L, int H, int D, int dtype,
                                int causal, float scale, void* stream) {
  const Bwd a{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(di), dk, dv, ws, B, L, H, D, causal,
              scale, static_cast<cudaStream_t>(stream)};
  return launch_bwd_any(a, dtype, kDkv);
}

// dq of the forward, from the same inputs as the dK/dV kernels; ws of
// pio_flash_attn_huge_workspace(..., 1, dtype) bytes.
int pio_flash_attn_huge_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* di, void* dq, void* ws, int B,
                               int L, int H, int D, int dtype, int causal,
                               float scale, void* stream) {
  const Bwd a{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(di), dq, nullptr, ws, B, L, H, D,
              causal, scale, static_cast<cudaStream_t>(stream)};
  return launch_bwd_any(a, dtype, kDq);
}

// The backward's plan for `kind` (1 dQ, 2 dK/dV), as ops/kernels.py::
// huge_bwd_plan computes it: out = {own tiles a band, (batch, head)s a
// band, bands, workspace bytes, then for the first band the score pass's
// grid x, y, z, threads a CTA, dynamic shared-memory bytes and the CTAs an
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), and
// the same six for the product pass}. Returns the cudaError of the query.
int pio_flash_attn_huge_bwd_plan(int B, int L, int H, int D, int dtype,
                                 int causal, int kind, long long* out) {
  Plan p;
  if (!bwd_plan(B, L, H, D, dtype, kind, &p))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = bwd_init();
  if (err != cudaSuccess) return (int)err;
  const Band band = band_of(p, kind, 0);
  const int threads[2] = {kScoreThreads, kind == kDkv ? 2 * kGroup : kGroup};
  const long long grids[2][3] = {
      {score_ctas(band, kind, causal != 0), band.nbh, 1},
      {D / kOut, band.nbh, band.tiles}};
  const long long head[4] = {p.tiles, p.heads, p.bands, p.ws_bytes};
  for (int i = 0; i < 4; ++i) out[i] = head[i];
  for (int pass = 0; pass < 2; ++pass) {
    int blocks = 0;
    const int smem = bwd_smem(dtype, kind, pass);
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, bwd_kernel(dtype, kind, causal != 0, pass), threads[pass],
        smem);
    if (e != cudaSuccess && err == cudaSuccess) err = e;
    long long* o = out + 4 + 6 * pass;
    o[0] = grids[pass][0];
    o[1] = grids[pass][1];
    o[2] = grids[pass][2];
    o[3] = threads[pass];
    o[4] = smem;
    o[5] = blocks;
  }
  return (int)err;
}

}  // extern "C"
