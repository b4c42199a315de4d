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
// causal mask (key j visible to query i iff j <= i), f32 scores, softmax
// and sums, outputs in the input dtype. With bf16 inputs every product is
// exact in f32; P is rounded to bf16 before P V and dV, and dS before dK
// and dQ, as the plain version rounds them; the row sum and dS use the
// unrounded P. With f32 inputs everything stays f32 on CUDA-core FFMAs: no
// TF32, no tensor cores.
//
// D here is a multiple of 128 above 1024 (the caller zero-pads the head dim
// up to one, which is exact).
//
// What bounds it on the card: operations, as for the wide kernels (4*D FLOP
// per visible pair forward, 8*D for dK/dV, 6*D for dQ), at the f32 FFMA
// peak for f32 and at the bf16 tensor-core peak for bf16.
//
// Every entry point runs as passes, each an ordinary tiled product or a
// row sweep with no cross-CTA sum. At these widths the score matrix is
// cheap beside the contractions over D: a visible pair costs 4*D >= 4,608
// FLOP forward and 8*D in dK/dV, and its S, P and dS 4 to 8 bytes in f32.
// - The score pass (huge_score, every entry point): one CTA per (batch,
//   head, 64-row own tile, 64-row other tile) that the mask leaves visible.
//   It forms the 64 x 64 tile's sums over all of D, D in chunks of 32
//   (f32) or 64 (bf16) features in increasing order, through a two-stage
//   cp.async ring of the row tiles. f32: register tiles, each thread 8 own
//   rows x 4 other rows, 16-byte shared loads along the features (12 loads
//   for 128 FFMAs a 4-feature step); bf16: mma.sync m16n8k16 fed by
//   ldmatrix, a warp 16 own rows x 64. The sums meet in shared memory for a
//   coalesced epilogue.
//   - Forward: S = Q K^T alone, 128 threads (warps 0-3), a ring of two
//     tiles (36 KiB, three CTAs an SM). It writes raw f32 S, -inf past L
//     and above the diagonal, [query][key].
//   - Backward: S and dP, 256 threads (warps 0-3 S, warps 4-7 dP), a ring
//     of four tiles (own Q or K, own dO or V, the other side's; three bf16
//     CTAs an SM, two f32). The epilogue: P = exp2(S * s * log2(e) - lse *
//     log2(e)), exact zeros past L and above the diagonal, dS = (dP - di) *
//     P * s from the unrounded P, both rounded to bf16 for bf16 inputs,
//     written in the input type, laid out as the product pass reads its
//     operand: [key][query] (P^T, then dS^T) for dK/dV, [query][key] (dS)
//     for dQ.
// - The softmax pass (huge_softmax, the forward): a warp a query row, 8
//   rows a CTA. m = the row's largest S * s * log2(e) over its visible key
//   tiles; l = sum exp2(S * s * log2(e) - m), each lane its two columns of
//   every tile in increasing position, then a fixed xor-shuffle tree; lse =
//   m ln(2) + log(l), written when asked; P = exp2(S * s * log2(e) - lse *
//   log2(e)), the backward epilogue's expression, so the forward's P and
//   the backward's rebuilt P are the same bits on the same S and lse. P is
//   in the input type: f32 over S in place (a tile is read and written by
//   one warp a row), bf16 to a plane of its own after S.
// - The product pass (huge_product): one CTA per (batch, head, 64-row own
//   tile, 128-feature slice of D), 128 threads an output (dK/dV: dV = P^T
//   dO and dK = dS^T Q, 256 threads; dQ: dQ = dS K, 128; the forward: O = P
//   V, dQ's product with V for K). The other side's visible tiles are
//   summed in increasing position through a two-stage cp.async ring of the
//   workspace tile and the 64 x 128 slice of dO, Q, K or V. f32: each
//   thread 8 own rows x 8 features (16 shared loads for 256 FFMAs a 4-row
//   step); bf16: mma.sync, a warp 16 own rows x 128. The sums stay in
//   registers and are written once, in the input type.
// - Bands: the workspace holds at most 256 MiB (kWsCap). dK/dV bands over
//   own key tiles, dQ and the forward over own query tiles, so every output
//   row is complete in one band: no sum across bands, no atomics. A band is
//   the most own tiles of all (batch, head)s that fit the cap (one tile of
//   a group of (batch, head)s where even one tile of every head does not),
//   its passes in order on the caller's stream; under a causal mask each
//   band takes its heaviest own tiles first (dK/dV's first key tiles, dQ's
//   and the forward's last query tiles), and so do the bands. An own tile
//   of one (batch, head) takes nt 64 x 64 tiles of 4 (f32) or 2 (bf16)
//   bytes an element a plane: two planes for dK/dV, one for dQ, the f32 S
//   plane (and the bf16 P plane) for the forward. ops/kernels.py::
//   huge_fwd_plan and huge_bwd_plan are the same plans in Python;
//   pio_flash_attn_huge_fwd_plan and pio_flash_attn_huge_bwd_plan report
//   them from the card.
// What the passes do about the first versions' faults (a CTA of four query
// rows, a block reduction for every 8 keys, scalar global loads, an f32
// accumulator in global memory, no tensor cores): a streamed feature serves
// the 64 rows of a tile; every load is a 16-byte cp.async into shared
// memory; no score is a block reduction; no accumulator lives in global
// memory (the workspace holds S, P and dS, written once and read once a
// feature slice); and the bf16 kernels use the tensor cores. The price is S
// formed by every entry point, and S, P and dS through the L2 (one f32
// [L, L] plane at L 1024 is 4 MiB).
//
// Determinism: no atomics; every sum runs in one fixed order (features in
// increasing order, inside an mma its own fixed order; the other side's
// tiles and rows in increasing position; a softmax row's lanes over the
// tiles in increasing position, then a fixed shuffle tree), so two runs
// give the same bits, and the forward's output bits do not depend on
// whether it writes the logsumexp.

#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

constexpr int kTile = 64;  // rows of a score tile on each side
constexpr int kTileElems = kTile * kTile;
constexpr int kOut = 128;  // features of a product CTA's slice
constexpr int kGroup = 128;  // threads of one product output
constexpr int kStages = 2;
constexpr int kSB = kTile + 4;  // row stride of the epilogue's f32 tiles
constexpr int kSoftmaxRows = 8;  // query rows of a softmax CTA, a warp each
constexpr long long kWsCap = 256ll << 20;  // workspace bytes, at most

// the product pass of a kind: the forward's O = P V is dQ's dS K
__host__ __device__ constexpr int product_kind(int kind) {
  return kind == kFwd ? kDq : kind;
}

// threads of a score CTA: the forward forms S alone, the backward S and dP
__host__ __device__ constexpr int score_threads(int kind) {
  return kind == kFwd ? 128 : 256;
}

// features of a score-pass chunk: 32 f32, 64 bf16 (128 bytes a row)
template <typename T>
__host__ __device__ constexpr int chunk() {
  return 128 / (int)sizeof(T);
}

// a score stage's row tiles: own and other Q or K (and, backward, dO or V)
template <typename T, int KIND>
__host__ __device__ constexpr int score_smem() {
  return kStages * (KIND == kFwd ? 2 : 4) * kTile *
         row_stride<T, chunk<T>()>() * (int)sizeof(T);
}

// an output's workspace tile [64][SA] and other-side slice [64][SY] a stage
template <typename T>
__host__ __device__ constexpr int product_stage_elems() {
  return kTile * (row_stride<T, kTile>() + row_stride<T, kOut>());
}

template <typename T, int KIND>
__host__ __device__ constexpr int product_smem() {
  return kStages * (KIND == kDkv ? 2 : 1) * product_stage_elems<T>() *
         (int)sizeof(T);
}

static_assert(score_smem<float, kDq>() >= 2 * kTile * kSB * 4 &&
                  score_smem<bf16, kDq>() >= 2 * kTile * kSB * 4 &&
                  score_smem<float, kFwd>() >= kTile * kSB * 4 &&
                  score_smem<bf16, kFwd>() >= kTile * kSB * 4,
              "the epilogue's S (and dP) tiles fit in the score ring");
static_assert(product_smem<float, kDkv>() <= 232448 &&
                  score_smem<float, kDq>() <= 232448,
              "a CTA's shared memory");

// a launch's arguments (the forward's product pass gets V for k and O for
// out0)
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void* out0;  // dk (dK/dV), dq (dQ), o (the forward's product)
  void* out1;  // dv (dK/dV)
  void* ws;    // one band's tiles: S (forward); P and dS, in the input type
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
// under a causal mask, sees the query tiles from its own on; dQ and the
// forward own query tiles and see the key tiles up to their own
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

// two neighbouring workspace values, likewise
__device__ __forceinline__ void put2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void put2(bf16* p, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(x0, x1);
}

// Score CTAs an SM: the forward's 128-thread CTAs 3 (a 272-CTA pass in
// one wave; at 4 the f32 CTA spills 60 bytes at 128 registers and its pass
// is 5% slower); backward f32 2 (128 registers; at 3, 80 registers spill
// and the pass is slower), bf16 3 (all of a 272-CTA pass resident, and more
// loads in flight: the bf16 pass waits on them)
template <typename T, int KIND>
__host__ __device__ constexpr int score_ctas_an_sm() {
  return KIND == kFwd || sizeof(T) == 2 ? 3 : 2;
}

template <typename T, int KIND, bool CAUSAL>
__global__ void __launch_bounds__(score_threads(KIND),
                                  score_ctas_an_sm<T, KIND>())
    huge_score(const Args a, const Band band) {
  constexpr int CH = chunk<T>(), SC = row_stride<T, CH>();
  constexpr int NT = score_threads(KIND), NTILES = KIND == kFwd ? 2 : 4;
  constexpr int NVEC = KIND == kFwd ? 1 : kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  // [stage][own S operand, other S operand(, own dP operand, other dP
  // operand)][row][SC]
  T* ring = reinterpret_cast<T*>(smem);
  __shared__ float lse_s[NVEC], di_s[NVEC];  // the tile's query rows
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
  // dK/dV: S^T = K Q^T, dP^T = V dO^T; dQ: S = Q K^T, dP = dO V^T; the
  // forward: S = Q K^T
  const T* own0 = static_cast<const T*>(KIND == kDkv ? a.k : a.q);
  const T* oth0 = static_cast<const T*>(KIND == kDkv ? a.q : a.k);
  const T* own1 = static_cast<const T*>(KIND == kDkv ? a.v : a.dout);
  const T* oth1 = static_cast<const T*>(KIND == kDkv ? a.dout : a.v);

  auto load_chunk = [&](int c, int st) {
    T* s = ring + st * NTILES * kTile * SC;
    const long long off = base + (long long)c * CH;
    stage_rows<T, CH, kTile, NT>(s, own0, off, rs, own_r0, L, CH);
    stage_rows<T, CH, kTile, NT>(s + kTile * SC, oth0, off, rs, oth_r0, L,
                                 CH);
    if constexpr (KIND != kFwd) {
      stage_rows<T, CH, kTile, NT>(s + 2 * kTile * SC, own1, off, rs, own_r0,
                                   L, CH);
      stage_rows<T, CH, kTile, NT>(s + 3 * kTile * SC, oth1, off, rs, oth_r0,
                                   L, CH);
    }
    cp_async_commit();
  };
  if constexpr (KIND != kFwd) {
    const int q_r0 = KIND == kDkv ? oth_r0 : own_r0;
    const long long rbase = ((long long)b * H + h) * L;
    stage_vec<kTile, NT>(lse_s, a.lse, rbase, q_r0, L);
    stage_vec<kTile, NT>(di_s, a.di, rbase, q_r0, L);
  }
  load_chunk(0, 0);  // lse and di travel in the first group

  const int half = KIND == kFwd ? 0 : threadIdx.x / 128;  // 0: S, 1: dP
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int chunks = D / CH;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; stage c + 1 (c - 1's) is free
    if (c + 1 < chunks) load_chunk(c + 1, (c + 1) % kStages);
    const T* X = ring + ((c % kStages) * NTILES + 2 * half) * kTile * SC;
    score_chunk(acc, X, X + kTile * SC);
  }
  __syncthreads();  // every chunk read: the ring holds the S (and dP) tiles
  float* Sb = reinterpret_cast<float*>(smem);  // [own][kSB], then dP
  put_acc(Sb + half * kTile * kSB, acc, T());
  __syncthreads();

  const long long tile =
      ((long long)blockIdx.y * band.tiles + (t - band.t0)) * band.nt + o;
  if constexpr (KIND == kFwd) {
    // raw S, f32, -inf where the mask hides the pair
    float* ws = static_cast<float*>(a.ws) + tile * kTileElems;
    for (int idx = threadIdx.x; idx < kTileElems / 4; idx += NT) {
      const int r = idx / (kTile / 4), c = (idx % (kTile / 4)) * 4;
      const float4 s4 = *reinterpret_cast<const float4*>(&Sb[r * kSB + c]);
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = own_r0 + r, key = oth_r0 + c + e;
        const bool seen = query < L && key < L && (!CAUSAL || key <= query);
        s[e] = seen ? lane4(s4, e) : -INFINITY;
      }
      put4(ws + r * kTile + c, s);
    }
  } else {
    constexpr int planes = KIND == kDkv ? 2 : 1;
    const float scale = a.scale, scale2 = a.scale * kLog2e;
    T* ws = static_cast<T*>(a.ws) + tile * planes * kTileElems;
    for (int idx = threadIdx.x; idx < kTileElems / 4; idx += NT) {
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
}

// The forward's softmax over one band's S tiles: warp w of CTA (x, y) takes
// query row 8 (x % 8) + w of own tile z = x / 8 in the product pass's
// order (the band's last tile first) of (batch, head) bh0 + y. s: the S
// plane; p: where P goes (s itself for f32); lse: null or [B, H, L].
template <typename T, bool CAUSAL>
__global__ void __launch_bounds__(32 * kSoftmaxRows)
    huge_softmax(float* s, T* p, float* __restrict__ lse, const Band band,
                 int L, float scale) {
  constexpr int kGroups = kTile / kSoftmaxRows;
  const int lane = threadIdx.x & 31;
  const int t = band.t0 + band.tiles - 1 - (int)blockIdx.x / kGroups;
  const int r = (blockIdx.x % kGroups) * kSoftmaxRows + threadIdx.x / 32;
  const int row = t * kTile + r;
  const int n = seen_tiles(kFwd, CAUSAL, t, band.nt);  // key tiles 0..n-1
  // this lane's two columns of key tile 0; key tile o's are o tiles on
  const long long at =
      ((long long)blockIdx.y * band.tiles + (t - band.t0)) * band.nt *
          kTileElems +
      r * kTile + 2 * lane;
  if (row >= L) {  // a padded row: P zero (its O row is never written)
    for (int o = 0; o < n; ++o)
      put2(p + at + (long long)o * kTileElems, 0.f, 0.f);
    return;
  }
  const float c = scale * kLog2e;
  auto pair = [&](int o) {
    return *reinterpret_cast<const float2*>(s + at +
                                            (long long)o * kTileElems);
  };
  float m = -INFINITY;
#pragma unroll 4
  for (int o = 0; o < n; ++o) {
    const float2 x = pair(o);
    m = fmaxf(m, fmaxf(x.x * c, x.y * c));
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  float l = 0.f;  // masked pairs: exp2(-inf) = 0
#pragma unroll 4
  for (int o = 0; o < n; ++o) {
    const float2 x = pair(o);
    l += exp2f(fmaf(x.x, c, -m));
    l += exp2f(fmaf(x.y, c, -m));
  }
  // a butterfly: every lane adds the same two values at every level, so all
  // hold the same bits
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) l += __shfl_xor_sync(0xffffffffu, l, d);
  const float row_lse = m * kLn2 + logf(l);
  if (lse != nullptr && lane == 0)
    lse[(long long)(band.bh0 + blockIdx.y) * L + row] = row_lse;
#pragma unroll 4
  for (int o = 0; o < n; ++o) {
    const float2 x = pair(o);
    put2(p + at + (long long)o * kTileElems, exp_lse(x.x, c, row_lse),
         exp_lse(x.y, c, row_lse));
  }
}

// f32: this thread's 8 own rows rg + 8 i by the 8 features 4 cg + 64 c + e
// of the slice (acc[2 i + c][e]) += A Y over one 64-row other tile, rows in
// increasing order; A [own][68] (P^T, dS^T, dS or P), Y [other][132]
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
    huge_product(const Args a, const Band band) {
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
  // dK/dV: dV = P^T dO, dK = dS^T Q; dQ: dQ = dS K (the forward: O = P V)
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
    if (o + 1 < o1) load_tile(o + 1, (it + 1) % kStages);
    const T* s = ring + ((it % kStages) * NOUT + m) * OUT_ELEMS;
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

// A launch's plan (ops/kernels.py::huge_fwd_plan, huge_bwd_plan): tiles and
// (batch, head)s a band, the bands, and the workspace bytes
struct Plan {
  int nt, tiles, heads;
  long long bh, bands, tile_bands, ws_bytes;
};

bool plan_of(int B, int L, int H, int D, int dtype, int kind, Plan* p) {
  if (!shape_ok(B, L, H, D) || (dtype != 0 && dtype != 1) ||
      (kind != kFwd && kind != kDq && kind != kDkv))
    return false;
  // bytes of one visible pair: the forward's f32 S (and its bf16 P), the
  // backward's P and dS or dS alone in the input type
  const long long esize = dtype == 0 ? 4 : 2;
  const long long pair =
      kTileElems * (kind == kFwd ? 4 + (dtype == 0 ? 0 : 2)
                                 : (kind == kDkv ? 2 : 1) * esize);
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
// heaviest first (dK/dV from the first key tile, dQ and the forward from
// the last query tile)
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

// The passes of a launch: 0 score, 1 product, 2 the forward's softmax;
// each pass's kernel, threads, dynamic shared memory and grid for a band
template <typename T, int KIND>
void* pass_kernel_t(bool causal, int pass) {
  constexpr int PK = product_kind(KIND);
  if (pass == 0)
    return causal ? (void*)huge_score<T, KIND, true>
                  : (void*)huge_score<T, KIND, false>;
  if (pass == 1)
    return causal ? (void*)huge_product<T, PK, true>
                  : (void*)huge_product<T, PK, false>;
  return causal ? (void*)huge_softmax<T, true> : (void*)huge_softmax<T, false>;
}

template <typename T>
void* pass_kernel_k(int kind, bool causal, int pass) {
  return kind == kFwd  ? pass_kernel_t<T, kFwd>(causal, pass)
         : kind == kDq ? pass_kernel_t<T, kDq>(causal, pass)
                       : pass_kernel_t<T, kDkv>(causal, pass);
}

void* pass_kernel(int dtype, int kind, bool causal, int pass) {
  return dtype == 0 ? pass_kernel_k<float>(kind, causal, pass)
                    : pass_kernel_k<bf16>(kind, causal, pass);
}

template <typename T>
int pass_smem_t(int kind, int pass) {
  if (pass == 0)
    return kind == kFwd ? score_smem<T, kFwd>() : score_smem<T, kDq>();
  if (pass == 1)
    return kind == kDkv ? product_smem<T, kDkv>() : product_smem<T, kDq>();
  return 0;
}

int pass_smem(int dtype, int kind, int pass) {
  return dtype == 0 ? pass_smem_t<float>(kind, pass)
                    : pass_smem_t<bf16>(kind, pass);
}

int pass_threads(int kind, int pass) {
  return pass == 0   ? score_threads(kind)
         : pass == 1 ? (kind == kDkv ? 2 * kGroup : kGroup)
                     : 32 * kSoftmaxRows;
}

dim3 pass_grid(const Band& band, int kind, bool causal, int D, int pass) {
  if (pass == 0) return dim3(score_ctas(band, kind, causal), band.nbh);
  if (pass == 1) return dim3(D / kOut, band.nbh, band.tiles);
  return dim3(kTile / kSoftmaxRows * band.tiles, band.nbh);
}

// Raise the dynamic shared-memory ceiling of every score and product
// kernel, once a process
cudaError_t huge_init() {
  static const cudaError_t err = [] {
    for (int dtype = 0; dtype < 2; ++dtype)
      for (int kind = kFwd; kind <= kDkv; ++kind)
        for (int causal = 0; causal < 2; ++causal)
          for (int pass = 0; pass < 2; ++pass) {
            const cudaError_t e = cudaFuncSetAttribute(
                pass_kernel(dtype, kind, causal, pass),
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                pass_smem(dtype, kind, pass));
            if (e != cudaSuccess) return e;
          }
    return cudaSuccess;
  }();
  return err;
}

// The forward, band by band: S into the workspace's f32 plane, the softmax
// (P over S for f32, into the bf16 plane after the plan's S plane for
// bf16), then O = P V as dQ's product with V for K and P for dS.
template <typename T, bool CAUSAL>
cudaError_t launch_fwd(const Args& a, float* lse, const Plan& p) {
  float* s = static_cast<float*>(a.ws);
  T* pw = reinterpret_cast<T*>(
      sizeof(T) == 4 ? s
                     : s + (long long)p.heads * p.tiles * p.nt * kTileElems);
  Args prod = a;
  prod.k = a.v;
  prod.ws = pw;
  for (long long i = 0; i < p.bands; ++i) {
    const Band band = band_of(p, kFwd, i);
    huge_score<T, kFwd, CAUSAL>
        <<<pass_grid(band, kFwd, CAUSAL, a.D, 0), score_threads(kFwd),
           score_smem<T, kFwd>(), a.stream>>>(a, band);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    huge_softmax<T, CAUSAL>
        <<<pass_grid(band, kFwd, CAUSAL, a.D, 2), 32 * kSoftmaxRows, 0,
           a.stream>>>(s, pw, lse, band, a.L, a.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    huge_product<T, kDq, CAUSAL>
        <<<pass_grid(band, kFwd, CAUSAL, a.D, 1), kGroup,
           product_smem<T, kDq>(), a.stream>>>(prod, band);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int launch_fwd_any(const Args& a, float* lse, int dtype) {
  Plan p;
  if (!plan_of(a.B, a.L, a.H, a.D, dtype, kFwd, &p) || a.ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t init = huge_init();
  if (init != cudaSuccess) return (int)init;
  cudaError_t err;
  if (dtype == 0)
    err = a.causal ? launch_fwd<float, true>(a, lse, p)
                   : launch_fwd<float, false>(a, lse, p);
  else
    err = a.causal ? launch_fwd<bf16, true>(a, lse, p)
                   : launch_fwd<bf16, false>(a, lse, p);
  return (int)err;
}

template <typename T, int KIND, bool CAUSAL>
cudaError_t launch_bwd(const Args& a, const Plan& p) {
  for (long long i = 0; i < p.bands; ++i) {
    const Band band = band_of(p, KIND, i);
    huge_score<T, KIND, CAUSAL>
        <<<pass_grid(band, KIND, CAUSAL, a.D, 0), score_threads(KIND),
           score_smem<T, KIND>(), a.stream>>>(a, band);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    huge_product<T, KIND, CAUSAL>
        <<<pass_grid(band, KIND, CAUSAL, a.D, 1), pass_threads(KIND, 1),
           product_smem<T, KIND>(), a.stream>>>(a, band);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int launch_bwd_any(const Args& a, int dtype, int kind) {
  Plan p;
  if ((kind != kDq && kind != kDkv) ||
      !plan_of(a.B, a.L, a.H, a.D, dtype, kind, &p) || a.ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t init = huge_init();
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

// A launch's plan from the card: out = {own tiles a band, (batch, head)s a
// band, bands, workspace bytes, then for each pass of `order`, in the first
// band: grid x, y, z, threads a CTA, dynamic shared-memory bytes and the
// CTAs an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor)}
int report_plan(int B, int L, int H, int D, int dtype, int kind, bool causal,
                const int* order, int passes, long long* out) {
  Plan p;
  if (!plan_of(B, L, H, D, dtype, kind, &p))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = huge_init();
  if (err != cudaSuccess) return (int)err;
  const Band band = band_of(p, kind, 0);
  const long long head[4] = {p.tiles, p.heads, p.bands, p.ws_bytes};
  for (int i = 0; i < 4; ++i) out[i] = head[i];
  for (int i = 0; i < passes; ++i) {
    const int pass = order[i];
    const dim3 grid = pass_grid(band, kind, causal, D, pass);
    const int threads = pass_threads(kind, pass);
    const int smem = pass_smem(dtype, kind, pass);
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, pass_kernel(dtype, kind, causal, pass), threads, smem);
    if (e != cudaSuccess && err == cudaSuccess) err = e;
    const long long got[6] = {grid.x, grid.y, grid.z, threads, smem, blocks};
    for (int j = 0; j < 6; ++j) out[4 + 6 * i + j] = got[j];
  }
  return (int)err;
}

}  // namespace

extern "C" {

// Bytes of workspace a call of `kind` (0 forward, 1 dQ, 2 dK/dV) with
// inputs of `dtype` (0 f32, 1 bf16) needs at [B, L, H, D]: one band's
// tiles, at most 256 MiB (the forward's f32 S, and for bf16 its P; the
// backward's P and dS in the input type); -1 for a shape the kernels do
// not take.
long long pio_flash_attn_huge_workspace(int B, int L, int H, int D, int kind,
                                        int dtype) {
  Plan p;
  return plan_of(B, L, H, D, dtype, kind, &p) ? p.ws_bytes : -1;
}

// q, k, v, o: [B, L, H, D] contiguous device buffers of one type (dtype 0 =
// f32, 1 = bf16), 16-byte aligned; D a multiple of 128 above 1024; L >= 1,
// B and H <= 65535 (the wrapper checks). lse: null, or a [B, H, L] f32
// device buffer that receives each row's logsumexp. ws:
// pio_flash_attn_huge_workspace(..., 0, dtype) bytes of device memory,
// 16-byte aligned. Launches the score, softmax and product pass of every
// band on `stream`; returns the first cudaError.
int pio_flash_attn_huge_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, void* ws, int B, int L, int H,
                            int D, int dtype, int causal, float scale,
                            void* stream) {
  const Args a{q, k, v, nullptr, nullptr, nullptr, o, nullptr, ws, B, L, H,
               D, causal, scale, static_cast<cudaStream_t>(stream)};
  return launch_fwd_any(a, static_cast<float*>(lse), dtype);
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
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
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
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dq, nullptr, ws, B, L, H, D,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return launch_bwd_any(a, dtype, kDq);
}

// The forward's plan, as ops/kernels.py::huge_fwd_plan computes it: out =
// {own tiles a band, (batch, head)s a band, bands, workspace bytes, then
// for the first band the score pass's grid x, y, z, threads a CTA, dynamic
// shared-memory bytes and the CTAs an SM holds at once, and the same six
// for the softmax pass and for the product pass}. Returns the cudaError of
// the query.
int pio_flash_attn_huge_fwd_plan(int B, int L, int H, int D, int dtype,
                                 int causal, long long* out) {
  const int order[3] = {0, 2, 1};
  return report_plan(B, L, H, D, dtype, kFwd, causal != 0, order, 3, out);
}

// The backward's plan for `kind` (1 dQ, 2 dK/dV), as ops/kernels.py::
// huge_bwd_plan computes it: out = {own tiles a band, (batch, head)s a
// band, bands, workspace bytes, then for the first band the score pass's
// six fields as above, and the same six for the product pass}. Returns the
// cudaError of the query.
int pio_flash_attn_huge_bwd_plan(int B, int L, int H, int D, int dtype,
                                 int causal, int kind, long long* out) {
  if (kind != kDq && kind != kDkv) return (int)cudaErrorInvalidValue;
  const int order[2] = {0, 1};
  return report_plan(B, L, H, D, dtype, kind, causal != 0, order, 2, out);
}

}  // extern "C"
