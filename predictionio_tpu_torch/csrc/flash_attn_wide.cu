// Exact attention backward for head dims above 256 on Hopper (sm_90a): dK/dV
// and dQ of O = softmax(Q K^T * s) V, for every head dim from 257 to 1024,
// each as a thread-block cluster over 128-feature slices of the head dim.
// The forward that writes the logsumexp these kernels read is in
// flash_attn_wide_fwd.cu.
//
// Replaces no TPU kernel. The JAX package answers these head dims with its
// plain blockwise_attention (predictionio_tpu/parallel/ring_attention.py::
// flash_attention sends every shape but D 64 and 128 there), so on a TPU
// they never reach a Pallas kernel. The port's rule is that a wrapper
// launches its kernel or raises on a CUDA tensor, never the plain version;
// these kernels are what the wrappers in ops/kernels.py launch for
// 256 < D <= 1024, where flash_attn_bwd.cu stops. Same function as the
// plain version in parallel/ring_attention.py (blockwise_attention_bwd) and
// as the narrow kernels: q, k, v, do [B, L, H, D] (f32 or bf16, row-major,
// contiguous), the scale s of the caller's original head dim, an optional
// causal mask (key j visible to query i iff j <= i), f32 accumulators,
// outputs in the input dtype. With bf16 inputs every product is exact in
// f32; P is rounded to bf16 before dV, and dS before dK and dQ, as the
// plain version rounds them; dS uses the unrounded P. With f32 inputs
// everything stays f32 on CUDA-core FFMAs: no TF32, no tensor cores.
//
// D here is a multiple of 128 from 384 to 1024 (the caller zero-pads the
// head dim up to one, which is exact, as for the narrow kernels).
//
// What bounds it on the card: operations. A call does 8*D FLOP per visible
// (query, key) pair for dK/dV and 6*D for dQ, against a few bytes a pair;
// the bound is that count at the f32 peak for f32 and at the bf16
// tensor-core peak for bf16.
//
// Split. Let n = D / 128 (3 to 8). One cluster of n CTAs takes one (batch,
// head, 64-row own tile); CTA r of the cluster owns features [128 r,
// 128 r + 128) of every tensor. dK/dV owns 64 keys and streams query tiles
// (under a causal mask from the first that reaches the diagonal); dQ owns
// 64 query rows and streams key tiles up to the diagonal. The own tile is
// the slowest grid axis, heaviest first as in flash_attn_bwd.cu: dK/dV's
// first key tiles, dQ's last query tiles. Each CTA runs the narrow
// kernel's head-dim-128 backward loop (flash_attn_bwd.cu) on its slice,
// 32 streamed rows a tile, through a three-stage cp.async ring:
// - f32: 256 threads, F32Tile<128, 32>'s SIMT register tiles (each thread
//   4 own rows x 2 streamed rows of S and dP, 4 own rows x 8 features of
//   each gradient), the own slice staged feature-major once, P and dS
//   through shared [streamed][own] buffers;
// - bf16: 128 threads, 16 own rows a warp, mma.sync m16n8k16 fed by
//   ldmatrix for all products, P^T and dS^T (P and dS for dQ) rounded to
//   bf16 in registers as the A operand of the gradient products.
//
// The exchange. A CTA's S and dP (S^T and dP^T for dK/dV) are partial sums
// over its 128 features. Each CTA writes both partial 64 x 32 f32 tiles to
// shared memory as one tile of lines (attn_tiles.cuh): f32 [streamed
// row][own row] (32 lines of 64 S then 64 dP; a thread's four own rows as
// one 16-byte vector), bf16 [own row][streamed row] (64 lines of 32 S then
// 32 dP; two neighbouring streamed rows as one 8-byte vector). After a
// cluster barrier the cluster reduce-scatters that tile through
// distributed shared memory: CTA r sums its lines of every CTA's partial in
// rank order 0, 1, ..., n - 1; after a second barrier every CTA reads the
// sums back from their owners. One exchange carries both S and dP, so a
// streamed tile costs two cluster barriers and 16 KB of partials a CTA.
// Every CTA thus holds the same bits of S and dP and builds the same P =
// exp2(S * s * log2(e) - lse * log2(e)) and dS = (dP - di) * P * s; it adds
// its own slice of dV += P^T dO and dK += dS^T Q (dK/dV) or dQ += dS K.
//
// Overlap. Each barrier is split into its arrive and its wait, and a CTA
// runs the previous tile's gradient products between them: dV in the
// first window and dK in the second (dK/dV), the first and the second half
// of the tile's keys of dQ += dS K (dQ). That keeps the previous tile's
// streamed rows, P and dS: the ring has three stages (tile t + 1 loads
// while tile t is formed and tile t - 1's products run), P and dS wait in
// shared buffers (f32) or in registers (bf16), and the last tile's
// products run after the loop. Two cluster barriers a tile are enough: the
// partial tile is written again only after the second barrier of the tile
// before (every owner has read it), the sums only after the first (every
// CTA has gathered them). A thread passes a wait once every thread has
// arrived, not once every thread has run its window, so the f32 P and dS
// buffers, which the windows read across warps, are rewritten only after a
// CTA barrier. One more cluster barrier before exit keeps each CTA's shared
// memory alive while the others read it.
//
// Determinism: no atomics, and every sum in one fixed order (features in
// increasing order within a slice, slices in rank order, streamed rows in
// increasing position), so two runs give the same bits.

#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr int kOwn = 64;          // own rows a cluster
constexpr int kStream = 32;       // rows of a streamed tile
constexpr int kStages = 3;        // the streamed ring
constexpr int kMaxTiles = 65535;  // grid z limit (own tiles)

constexpr int kF32Threads = 256;
constexpr int kBf16Threads = 128;

// the kernels a plan names (ops/kernels.py's codes)
constexpr int kDq = 1, kDkv = 2;

using G = F32Tile<kSlice, kStream>;
static_assert(G::BO == kOwn && G::TO == 4 && G::NJ == 2 && G::NF == 8 &&
                  G::SX == F32Fwd<kSlice, kOwn>::SX,
              "the f32 slice is the narrow backward's D-128 tile");

// the exchanged tile's lines: f32 [streamed][own] with S in floats [0, 64)
// and dP in [64, 128), bf16 [own][streamed] with S in [0, 32) and dP in
// [32, 64); the padding keeps each quarter (half) warp's stores on
// distinct banks. kOwnLines*: the lines the smallest cluster's CTA sums.
constexpr int kF32Lines = kStream, kF32Width = 2 * kOwn, kXF32 = kF32Width + 4;
constexpr int kBf16Lines = kOwn, kBf16Width = 2 * kStream,
              kXBf16 = kBf16Width + 8;
constexpr int kOwnLinesF32 = (kF32Lines + kMinCluster - 1) / kMinCluster;
constexpr int kOwnLinesBf16 = (kBf16Lines + kMinCluster - 1) / kMinCluster;

// the ring stage of streamed tile `it` and of the one before
__device__ __forceinline__ int stage_of(int it) { return it % kStages; }

// ---------------------------------------------------------------------------
// f32: CUDA-core register tiles

// Kt, Vt (Qt, dOt); the ring of (Q, dO) or (K, V); P and dS (dS alone for
// dQ); lse and di of each stage (dK/dV); the partial tile and the owned sums
constexpr int f32_floats(int kind) {
  return 2 * kSlice * G::SX + 2 * kStages * kStream * G::SY +
         (kind == kDkv ? 2 : 1) * kStream * G::SX +
         (kind == kDkv ? 2 * kStages * kStream : 0) +
         (kF32Lines + kOwnLinesF32) * kXF32;
}

// the summed S and dP of a thread's block from their owners (f32 lines)
__device__ __forceinline__ void gather_f32(cg::cluster_group& cluster,
                                           float* Ys, float (&s)[G::TO][G::NJ],
                                           float (&dp)[G::TO][G::NJ], int og,
                                           int sr, int n) {
#pragma unroll
  for (int j = 0; j < G::NJ; ++j) {
    const float* line =
        summed<kF32Lines, kXF32>(cluster, Ys, sr + 8 * j, og * G::TO, n);
    const float4 u = *reinterpret_cast<const float4*>(line);
    const float4 w = *reinterpret_cast<const float4*>(line + kOwn);
    s[0][j] = u.x, s[1][j] = u.y, s[2][j] = u.z, s[3][j] = u.w;
    dp[0][j] = w.x, dp[1][j] = w.y, dp[2][j] = w.z, dp[3][j] = w.w;
  }
}

// a thread's partial S and dP block to the exchanged tile (f32 lines)
__device__ __forceinline__ void scatter_f32(float* Xs,
                                            const float (&s)[G::TO][G::NJ],
                                            const float (&dp)[G::TO][G::NJ],
                                            int og, int sr) {
#pragma unroll
  for (int j = 0; j < G::NJ; ++j) {
    float* line = Xs + (sr + 8 * j) * kXF32 + og * G::TO;
    *reinterpret_cast<float4*>(line) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    *reinterpret_cast<float4*>(line + kOwn) =
        make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kF32Threads, 1)
wide_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             float* __restrict__ dk, float* __restrict__ dv, int L, int H,
             int D, float scale) {
  constexpr int BS = kStream, TO = G::TO, NJ = G::NJ, SX = G::SX, SY = G::SY;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                            // Kt[d * SX + key], this slice
  float* Vt = Kt + kSlice * SX;
  float* ring = Vt + kSlice * SX;              // [stage][Q, dO][query][SY]
  float* Pb = ring + 2 * kStages * BS * SY;    // the tile before's P [q][SX]
  float* dSb = Pb + BS * SX;                   // and its dS
  float* rows = dSb + BS * SX;                 // [stage][lse, di][query]
  float* Xs = rows + 2 * kStages * BS;         // partial S^T, dP^T [q][kXF32]
  float* Ys = Xs + kF32Lines * kXF32;          // the sums of its own lines
  const F32Roles<BS> t;
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x / n, b = blockIdx.y, k0 = blockIdx.z * kOwn;
  const long long rs = (long long)H * D;  // elements between positions
  const long long base =
      (long long)b * L * rs + (long long)h * D + rank * kSlice;
  const long long rbase = ((long long)b * H + h) * L;  // lse, di rows

  auto prefetch = [&](int q0, int st) {
    float* Qs = ring + 2 * st * BS * SY;
    stage_rows<float, kSlice, BS, kF32Threads>(Qs, q, base, rs, q0, L,
                                               kSlice);
    stage_rows<float, kSlice, BS, kF32Threads>(Qs + BS * SY, dout, base, rs,
                                               q0, L, kSlice);
    stage_vec<BS, kF32Threads>(rows + 2 * st * BS, lse, rbase, q0, L);
    stage_vec<BS, kF32Threads>(rows + (2 * st + 1) * BS, di, rbase, q0, L);
    cp_async_commit();
  };
  // under the causal mask no query before k0 sees this key tile
  const int q_begin = kCausal ? k0 : 0;
  prefetch(q_begin, 0);
  stage_qt<kSlice, kOwn, kF32Threads>(Kt, k, base, rs, k0, L, kSlice);
  stage_qt<kSlice, kOwn, kF32Threads>(Vt, v, base, rs, k0, L, kSlice);

  float adk[TO][G::NF], adv[TO][G::NF];
#pragma unroll
  for (int i = 0; i < TO; ++i)
#pragma unroll
    for (int c = 0; c < G::NF; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int tiles = (L - q_begin + BS - 1) / BS;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = q_begin + it * BS, st = stage_of(it);
    cp_async_wait_all();
    // tile it landed; stage it + 1 (it - 2's) is free: its products ran
    // before the last cluster barrier
    __syncthreads();
    if (it + 1 < tiles) prefetch(q0 + BS, stage_of(it + 1));
    const float* Qs = ring + 2 * st * BS * SY;
    const float* dOs = Qs + BS * SY;
    const float* lse_s = rows + 2 * st * BS;
    const float* di_s = lse_s + BS;
    const float* Qp = ring + 2 * stage_of(it + kStages - 1) * BS * SY;
    const float* dOp = Qp + BS * SY;  // the tile before's

    // s[i][j], dp[i][j]: key k0 + og * TO + i, query q0 + sr + 8 j; this
    // slice's part
    float s[TO][NJ], dp[TO][NJ];
#pragma unroll
    for (int i = 0; i < TO; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    st_dot<G>(s, Kt, Qs, t.og, t.sr);    // S^T = K Q^T
    st_dot<G>(dp, Vt, dOs, t.og, t.sr);  // dP^T = V dO^T

    // the whole S^T and dP^T: partials out, reduce-scatter, sums back; the
    // tile before's dV and dK run while each barrier completes
    scatter_f32(Xs, s, dp, t.og, t.sr);
    cluster_arrive();
    if (it > 0) buf_dot<G>(adv, Pb, dOp, t.og, t.fg);  // dV += P^T dO
    cluster_wait();  // every CTA's partial landed
    sum_own_lines<kF32Threads, kF32Lines, kXF32, kF32Width>(cluster, Xs, Ys,
                                                           rank, n);
    cluster_arrive();
    if (it > 0) buf_dot<G>(adk, dSb, Qp, t.og, t.fg);  // dK += dS^T Q
    cluster_wait();  // every owner's sums landed
    gather_f32(cluster, Ys, s, dp, t.og, t.sr, n);

    // every pair of the tile visible: no mask
    const bool inner = q0 + BS <= L && k0 + kOwn <= L &&
                       (!kCausal || k0 + kOwn - 1 <= q0);
#pragma unroll
    for (int i = 0; i < TO; ++i) {
      const int key = k0 + t.og * TO + i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = t.sr + 8 * j, row = q0 + r;
        const bool ok =
            inner || (row < L && key < L && (!kCausal || key <= row));
        const float pf = ok ? exp_lse(s[i][j], scale2, lse_s[r]) : 0.f;
        s[i][j] = pf;
        dp[i][j] = (dp[i][j] - di_s[r]) * pf * scale;
      }
    }
    // the second window's products still read dS: a thread is past the
    // second wait once every thread arrived, not once every thread is done
    __syncthreads();
    put_block<G>(Pb, s, t.og, t.sr);
    put_block<G>(dSb, dp, t.og, t.sr);
  }
  __syncthreads();  // the last tile's P and dS written
  const float* Ql = ring + 2 * stage_of(tiles - 1) * BS * SY;
  buf_dot<G>(adv, Pb, Ql + BS * SY, t.og, t.fg);
  buf_dot<G>(adk, dSb, Ql, t.og, t.fg);
  cluster.sync();  // no CTA leaves while another reads its sums
  write_f32<G>(dk, adk, base, rs, k0, L, kSlice, t.og, t.fg);
  write_f32<G>(dv, adv, base, rs, k0, L, kSlice, t.og, t.fg);
}

template <bool kCausal>
__global__ void __launch_bounds__(kF32Threads, 1)
wide_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ dq, int L, int H, int D, float scale) {
  constexpr int BS = kStream, TO = G::TO, NJ = G::NJ, SX = G::SX, SY = G::SY;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                            // Qt[d * SX + query]
  float* dOt = Qt + kSlice * SX;
  float* ring = dOt + kSlice * SX;             // [stage][K, V][key][SY]
  float* dSb = ring + 2 * kStages * BS * SY;   // the tile before's dS [k][SX]
  float* Xs = dSb + BS * SX;                   // partial S, dP [key][kXF32]
  float* Ys = Xs + kF32Lines * kXF32;
  const F32Roles<BS> t;
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x / n, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn;
  const long long rs = (long long)H * D;
  const long long base =
      (long long)b * L * rs + (long long)h * D + rank * kSlice;
  const long long rbase = ((long long)b * H + h) * L;
  const int kv_end = kCausal ? min(L, q0 + kOwn) : L;

  auto prefetch = [&](int k0, int st) {
    float* Ks = ring + 2 * st * BS * SY;
    stage_rows<float, kSlice, BS, kF32Threads>(Ks, k, base, rs, k0, L,
                                               kSlice);
    stage_rows<float, kSlice, BS, kF32Threads>(Ks + BS * SY, v, base, rs, k0,
                                               L, kSlice);
    cp_async_commit();
  };
  prefetch(0, 0);
  stage_qt<kSlice, kOwn, kF32Threads>(Qt, q, base, rs, q0, L, kSlice);
  stage_qt<kSlice, kOwn, kF32Threads>(dOt, dout, base, rs, q0, L, kSlice);
  float lse_r[TO], di_r[TO];  // queries q0 + og * TO + i
#pragma unroll
  for (int i = 0; i < TO; ++i) {
    const int row = q0 + t.og * TO + i;
    lse_r[i] = row < L ? lse[rbase + row] : 0.f;
    di_r[i] = row < L ? di[rbase + row] : 0.f;
  }

  float acc[TO][G::NF];
#pragma unroll
  for (int i = 0; i < TO; ++i)
#pragma unroll
    for (int c = 0; c < G::NF; ++c) acc[i][c] = 0.f;

  const int tiles = (kv_end + BS - 1) / BS;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * BS;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; stage it + 1 (it - 2's) is free
    if (it + 1 < tiles) prefetch(k0 + BS, stage_of(it + 1));
    const float* Ks = ring + 2 * stage_of(it) * BS * SY;
    const float* Vs = Ks + BS * SY;
    const float* Kp = ring + 2 * stage_of(it + kStages - 1) * BS * SY;

    // s[i][j], dp[i][j]: query q0 + og * TO + i, key k0 + sr + 8 j; this
    // slice's part
    float s[TO][NJ], dp[TO][NJ];
#pragma unroll
    for (int i = 0; i < TO; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    st_dot<G>(s, Qt, Ks, t.og, t.sr);    // S = Q K^T
    st_dot<G>(dp, dOt, Vs, t.og, t.sr);  // dP = dO V^T

    // the whole S and dP; the tile before's dQ += dS K runs while each
    // barrier completes, half its keys in each window
    scatter_f32(Xs, s, dp, t.og, t.sr);
    cluster_arrive();
    if (it > 0) buf_dot<G, 0, BS / 2>(acc, dSb, Kp, t.og, t.fg);
    cluster_wait();  // every CTA's partial landed
    sum_own_lines<kF32Threads, kF32Lines, kXF32, kF32Width>(cluster, Xs, Ys,
                                                           rank, n);
    cluster_arrive();
    if (it > 0) buf_dot<G, BS / 2, BS>(acc, dSb, Kp, t.og, t.fg);
    cluster_wait();  // every owner's sums landed
    gather_f32(cluster, Ys, s, dp, t.og, t.sr, n);

    const bool inner = q0 + kOwn <= L && k0 + BS <= L &&
                       (!kCausal || k0 + BS - 1 <= q0);
#pragma unroll
    for (int i = 0; i < TO; ++i) {
      const int row = q0 + t.og * TO + i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + t.sr + 8 * j;
        const bool ok =
            inner || (row < L && col < L && (!kCausal || col <= row));
        const float pf = ok ? exp_lse(s[i][j], scale2, lse_r[i]) : 0.f;
        dp[i][j] = (dp[i][j] - di_r[i]) * pf * scale;
      }
    }
    __syncthreads();  // the second window's products read dS
    put_block<G>(dSb, dp, t.og, t.sr);
  }
  __syncthreads();  // the last tile's dS written
  buf_dot<G>(acc, dSb, ring + 2 * stage_of(tiles - 1) * BS * SY, t.og,
             t.fg);
  cluster.sync();  // no CTA leaves while another reads its sums
  write_f32<G>(dq, acc, base, rs, q0, L, kSlice, t.og, t.fg);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16 fed by ldmatrix

constexpr int kBS = row_stride<bf16, kSlice>();  // bf16 rows

// the own rows' two tiles (K, V or Q, dO); the ring; lse and di of each
// stage (dK/dV); the partial tile and the owned sums
constexpr int bf16_bytes(int kind) {
  return (2 * kOwn + 2 * kStages * kStream) * kBS * 2 +
         (kind == kDkv ? 2 * kStages * kStream * 4 : 0) +
         (kBf16Lines + kOwnLinesBf16) * kXBf16 * 4;
}

// a warp's partial S and dP (rows r0 + g (+ 8), streamed 8 nt + 2 t (+ 1))
// to the exchanged tile (bf16 lines), and the sums back from their owners
__device__ __forceinline__ void scatter_bf16(float* Xs,
                                             const float (&s)[kStream / 8][4],
                                             const float (&dp)[kStream / 8][4],
                                             int r0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float* line = Xs + (r0 + g + 8 * half) * kXBf16 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kStream / 8; ++nt) {
      *reinterpret_cast<float2*>(line + 8 * nt) =
          make_float2(s[nt][2 * half], s[nt][2 * half + 1]);
      *reinterpret_cast<float2*>(line + kStream + 8 * nt) =
          make_float2(dp[nt][2 * half], dp[nt][2 * half + 1]);
    }
  }
}

__device__ __forceinline__ void gather_bf16(cg::cluster_group& cluster,
                                            float* Ys,
                                            float (&s)[kStream / 8][4],
                                            float (&dp)[kStream / 8][4],
                                            int r0, int n) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float* line = summed<kBf16Lines, kXBf16>(cluster, Ys,
                                                   r0 + g + 8 * half, 2 * t, n);
#pragma unroll
    for (int nt = 0; nt < kStream / 8; ++nt) {
      const float2 x = *reinterpret_cast<const float2*>(line + 8 * nt);
      const float2 y =
          *reinterpret_cast<const float2*>(line + kStream + 8 * nt);
      s[nt][2 * half] = x.x, s[nt][2 * half + 1] = x.y;
      dp[nt][2 * half] = y.x, dp[nt][2 * half + 1] = y.y;
    }
  }
}

template <bool kCausal>
__global__ void __launch_bounds__(kBf16Threads)
wide_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H,
              int D, float scale) {
  constexpr int S = kBS, BS = kStream, NS = BS / 8, NF = kSlice / 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_b);  // [key][S], this slice
  bf16* Vs = Ks + kOwn * S;
  bf16* ring = Vs + kOwn * S;                   // [stage][Q, dO][query][S]
  float* rows = reinterpret_cast<float*>(ring + 2 * kStages * BS * S);
  float* Xs = rows + 2 * kStages * BS;          // partial S^T, dP^T [key][]
  float* Ys = Xs + kBf16Lines * kXBf16;         // the sums of its own lines
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int kr = warp * 16;                     // this warp's keys in the tile
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x / n, b = blockIdx.y, k0 = blockIdx.z * kOwn;
  const long long rs = (long long)H * D;
  const long long base =
      (long long)b * L * rs + (long long)h * D + rank * kSlice;
  const long long rbase = ((long long)b * H + h) * L;

  auto prefetch = [&](int q0, int st) {
    bf16* Qs = ring + 2 * st * BS * S;
    stage_rows<bf16, kSlice, BS, kBf16Threads>(Qs, q, base, rs, q0, L,
                                               kSlice);
    stage_rows<bf16, kSlice, BS, kBf16Threads>(Qs + BS * S, dout, base, rs,
                                               q0, L, kSlice);
    stage_vec<BS, kBf16Threads>(rows + 2 * st * BS, lse, rbase, q0, L);
    stage_vec<BS, kBf16Threads>(rows + (2 * st + 1) * BS, di, rbase, q0, L);
    cp_async_commit();
  };
  stage_rows<bf16, kSlice, kOwn, kBf16Threads>(Ks, k, base, rs, k0, L,
                                               kSlice);
  stage_rows<bf16, kSlice, kOwn, kBf16Threads>(Vs, v, base, rs, k0, L,
                                               kSlice);
  const int q_begin = kCausal ? k0 : 0;
  prefetch(q_begin, 0);  // K and V travel in the first group

  // adk, adv: this warp's keys x features 8 f + 2 t (+ 1) of the slice; pa,
  // da: the tile before's P^T and dS^T, rounded to bf16, as A operands
  float adk[NF][4], adv[NF][4];
  uint32_t pa[NS][2], da[NS][2];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[f][e] = adv[f][e] = 0.f;

  const int tiles = (L - q_begin + BS - 1) / BS;
  for (int it = 0; it < tiles; ++it) {
    const int q0 = q_begin + it * BS, st = stage_of(it);
    cp_async_wait_all();
    __syncthreads();  // tile it landed; stage it + 1 (it - 2's) is free
    if (it + 1 < tiles) prefetch(q0 + BS, stage_of(it + 1));
    const bf16* Qs = ring + 2 * st * BS * S;
    const bf16* dOs = Qs + BS * S;
    const float* lse_s = rows + 2 * st * BS;
    const float* di_s = lse_s + BS;
    const bf16* Qp = ring + 2 * stage_of(it + kStages - 1) * BS * S;
    const bf16* dOp = Qp + BS * S;

    // s[nt][e], dp[nt][e]: key k0 + kr + g + 8 (e / 2), query q0 + 8 nt +
    // 2 t + e % 2; this slice's part
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    mma_rows<kSlice, NS>(s, Ks, Qs, kr);    // S^T = K Q^T
    mma_rows<kSlice, NS>(dp, Vs, dOs, kr);  // dP^T = V dO^T

    scatter_bf16(Xs, s, dp, kr);
    cluster_arrive();
    if (it > 0) mma_feats<kSlice, BS>(adv, pa, dOp);  // dV += P^T dO
    cluster_wait();  // every CTA's partial landed
    sum_own_lines<kBf16Threads, kBf16Lines, kXBf16, kBf16Width>(
        cluster, Xs, Ys, rank, n);
    cluster_arrive();
    if (it > 0) mma_feats<kSlice, BS>(adk, da, Qp);  // dK += dS^T Q
    cluster_wait();  // every owner's sums landed
    gather_bf16(cluster, Ys, s, dp, kr, n);

    const bool inner = q0 + BS <= L && k0 + kOwn <= L &&
                       (!kCausal || k0 + kOwn - 1 <= q0);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kr + g + 8 * (e >> 1);
        const int r = 8 * nt + 2 * t + (e & 1), row = q0 + r;
        const bool ok =
            inner || (row < L && key < L && (!kCausal || key <= row));
        const float pf = ok ? exp_lse(s[nt][e], scale2, lse_s[r]) : 0.f;
        s[nt][e] = pf;
        dp[nt][e] = (dp[nt][e] - di_s[r]) * pf * scale;
      }
      pa[nt][0] = pack_bf16(s[nt][0], s[nt][1]);
      pa[nt][1] = pack_bf16(s[nt][2], s[nt][3]);
      da[nt][0] = pack_bf16(dp[nt][0], dp[nt][1]);
      da[nt][1] = pack_bf16(dp[nt][2], dp[nt][3]);
    }
  }
  const bf16* Ql = ring + 2 * stage_of(tiles - 1) * BS * S;
  mma_feats<kSlice, BS>(adv, pa, Ql + BS * S);
  mma_feats<kSlice, BS>(adk, da, Ql);
  cluster.sync();  // no CTA leaves while another reads its sums
  write_bf16<kSlice>(dk, adk, base, rs, k0 + kr, L, kSlice);
  write_bf16<kSlice>(dv, adv, base, rs, k0 + kr, L, kSlice);
}

template <bool kCausal>
__global__ void __launch_bounds__(kBf16Threads)
wide_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dq, int L, int H, int D, float scale) {
  constexpr int S = kBS, BS = kStream, NS = BS / 8, NF = kSlice / 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_b);  // [query][S], this slice
  bf16* dOs = Qs + kOwn * S;
  bf16* ring = dOs + kOwn * S;                  // [stage][K, V][key][S]
  float* Xs = reinterpret_cast<float*>(ring + 2 * kStages * BS * S);
  float* Ys = Xs + kBf16Lines * kXBf16;
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int qr = warp * 16;                     // this warp's queries
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x / n, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kOwn;
  const long long rs = (long long)H * D;
  const long long base =
      (long long)b * L * rs + (long long)h * D + rank * kSlice;
  const long long rbase = ((long long)b * H + h) * L;
  const int kv_end = kCausal ? min(L, q0 + kOwn) : L;

  auto prefetch = [&](int k0, int st) {
    bf16* Kr = ring + 2 * st * BS * S;
    stage_rows<bf16, kSlice, BS, kBf16Threads>(Kr, k, base, rs, k0, L,
                                               kSlice);
    stage_rows<bf16, kSlice, BS, kBf16Threads>(Kr + BS * S, v, base, rs, k0,
                                               L, kSlice);
    cp_async_commit();
  };
  stage_rows<bf16, kSlice, kOwn, kBf16Threads>(Qs, q, base, rs, q0, L,
                                               kSlice);
  stage_rows<bf16, kSlice, kOwn, kBf16Threads>(dOs, dout, base, rs, q0, L,
                                               kSlice);
  prefetch(0, 0);  // Q and dO travel in the first group
  float lse_r[2], di_r[2];  // queries q0 + qr + g and + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qr + g + 8 * half;
    lse_r[half] = row < L ? lse[rbase + row] : 0.f;
    di_r[half] = row < L ? di[rbase + row] : 0.f;
  }

  // acc: this warp's queries x features 8 f + 2 t (+ 1) of the slice; da:
  // the tile before's dS, rounded to bf16, as the A operand of dS K
  float acc[NF][4];
  uint32_t da[NS][2];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;

  const int tiles = (kv_end + BS - 1) / BS;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * BS;
    cp_async_wait_all();
    __syncthreads();  // tile it landed; stage it + 1 (it - 2's) is free
    if (it + 1 < tiles) prefetch(k0 + BS, stage_of(it + 1));
    const bf16* Ks = ring + 2 * stage_of(it) * BS * S;
    const bf16* Vs = Ks + BS * S;
    const bf16* Kp = ring + 2 * stage_of(it + kStages - 1) * BS * S;

    // s[nt][e], dp[nt][e]: query q0 + qr + g + 8 (e / 2), key k0 + 8 nt +
    // 2 t + e % 2; this slice's part
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    mma_rows<kSlice, NS>(s, Qs, Ks, qr);    // S = Q K^T
    mma_rows<kSlice, NS>(dp, dOs, Vs, qr);  // dP = dO V^T

    // the tile before's dQ += dS K, one 16-key step in each window
    scatter_bf16(Xs, s, dp, qr);
    cluster_arrive();
    if (it > 0) mma_feats<kSlice, BS, 0, 1>(acc, da, Kp);
    cluster_wait();  // every CTA's partial landed
    sum_own_lines<kBf16Threads, kBf16Lines, kXBf16, kBf16Width>(
        cluster, Xs, Ys, rank, n);
    cluster_arrive();
    if (it > 0) mma_feats<kSlice, BS, 1, 2>(acc, da, Kp);
    cluster_wait();  // every owner's sums landed
    gather_bf16(cluster, Ys, s, dp, qr, n);

    const bool inner = q0 + kOwn <= L && k0 + BS <= L &&
                       (!kCausal || k0 + BS - 1 <= q0);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + qr + g + 8 * (e >> 1);
        const int col = k0 + 8 * nt + 2 * t + (e & 1);
        const bool ok =
            inner || (row < L && col < L && (!kCausal || col <= row));
        const float pf = ok ? exp_lse(s[nt][e], scale2, lse_r[e >> 1]) : 0.f;
        dp[nt][e] = (dp[nt][e] - di_r[e >> 1]) * pf * scale;
      }
      da[nt][0] = pack_bf16(dp[nt][0], dp[nt][1]);
      da[nt][1] = pack_bf16(dp[nt][2], dp[nt][3]);
    }
  }
  mma_feats<kSlice, BS>(acc, da, ring + 2 * stage_of(tiles - 1) * BS * S);
  cluster.sync();  // no CTA leaves while another reads its sums
  write_bf16<kSlice>(dq, acc, base, rs, q0 + qr, L, kSlice);
}

// ---------------------------------------------------------------------------
// launch

static_assert(f32_floats(kDkv) * 4 <= 232448 && f32_floats(kDq) * 4 <= 232448 &&
                  bf16_bytes(kDkv) <= 232448 && bf16_bytes(kDq) <= 232448,
              "a CTA's shared memory");
static_assert(kBf16Width == 2 * kStream && kStream / 16 == 2,
              "dQ's two windows take one 16-key step each");

int smem_bytes(int dtype, int kind) {
  return dtype == 0 ? f32_floats(kind) * (int)sizeof(float)
                    : bf16_bytes(kind);
}

void* kernel_of(int dtype, int causal, int kind) {
  if (dtype == 0) {
    if (kind == kDkv)
      return causal ? (void*)wide_dkv_f32<true> : (void*)wide_dkv_f32<false>;
    return causal ? (void*)wide_dq_f32<true> : (void*)wide_dq_f32<false>;
  }
  if (kind == kDkv)
    return causal ? (void*)wide_dkv_bf16<true> : (void*)wide_dkv_bf16<false>;
  return causal ? (void*)wide_dq_bf16<true> : (void*)wide_dq_bf16<false>;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void* out0;  // dk (dK/dV), dq (dQ)
  void* out1;  // dv (dK/dV)
  int B, L, H, D, dtype, causal, kind;
  float scale;
  cudaStream_t stream;
};

// the launch: a cluster of D / 128 CTAs along x; grid (n * H, B, own
// tiles); the kernels walk the own tiles heaviest first
cudaLaunchConfig_t plan(const Args& a, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int n = a.D / kSlice;
  cfg.gridDim = dim3(n * a.H, a.B, (a.L + kOwn - 1) / kOwn);
  cfg.blockDim = dim3(a.dtype == 0 ? kF32Threads : kBf16Threads);
  cfg.dynamicSmemBytes = smem_bytes(a.dtype, a.kind);
  cfg.stream = a.stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool takes(int B, int L, int H, int D, int dtype, int kind) {
  return B > 0 && L > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         D >= kMinCluster * kSlice && D <= kMaxCluster * kSlice &&
         D % kSlice == 0 && (L + kOwn - 1) / kOwn <= kMaxTiles &&
         (dtype == 0 || dtype == 1) && (kind == kDq || kind == kDkv);
}

template <typename T, typename K>
cudaError_t launch_dkv(const Args& a, K kernel) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan(a, &attr);
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.L, a.H, a.D,
      a.scale);
}

template <typename T, typename K>
cudaError_t launch_dq(const Args& a, K kernel) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan(a, &attr);
  return cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.out0), a.L, a.H, a.D, a.scale);
}

int launch(const Args& a) {
  if (!takes(a.B, a.L, a.H, a.D, a.dtype, a.kind))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (a.dtype == 0) {
    if (a.kind == kDkv)
      err = a.causal ? launch_dkv<float>(a, wide_dkv_f32<true>)
                     : launch_dkv<float>(a, wide_dkv_f32<false>);
    else
      err = a.causal ? launch_dq<float>(a, wide_dq_f32<true>)
                     : launch_dq<float>(a, wide_dq_f32<false>);
  } else {
    if (a.kind == kDkv)
      err = a.causal ? launch_dkv<bf16>(a, wide_dkv_bf16<true>)
                     : launch_dkv<bf16>(a, wide_dkv_bf16<false>);
    else
      err = a.causal ? launch_dq<bf16>(a, wide_dq_bf16<true>)
                     : launch_dq<bf16>(a, wide_dq_bf16<false>);
  }
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// Raise the dynamic shared-memory ceiling of the eight kernels (once).
int pio_flash_attn_wide_bwd_init() {
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int causal = 0; causal < 2; ++causal)
      for (int kind = kDq; kind <= kDkv; ++kind) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel_of(dtype, causal, kind),
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            smem_bytes(dtype, kind));
        if (err != cudaSuccess) return (int)err;
      }
  return (int)cudaSuccess;
}

// dk, dv of the forward for the output gradient do: q, k, v, do, dk, dv
// [B, L, H, D] contiguous, 16-byte aligned device buffers of one type
// (dtype 0 = f32, 1 = bf16); D a multiple of 128 from 384 to 1024; L >= 1
// and at most 65535 tiles of 64, B and H <= 65535 (the wrapper checks); lse
// the forward's logsumexp and di = rowsum(do * o), [B, H, L] f32. Launches
// on `stream`; returns the cudaError of the launch.
int pio_flash_attn_wide_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dk, void* dv, int B,
                                int L, int H, int D, int dtype, int causal,
                                float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dk, dv, B, L, H, D, dtype,
               causal, kDkv, scale, static_cast<cudaStream_t>(stream)};
  return launch(a);
}

// dq of the forward, from the same inputs as the dK/dV kernel.
int pio_flash_attn_wide_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* di, void* dq, int B, int L, int H,
                               int D, int dtype, int causal, float scale,
                               void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dq, nullptr, B, L, H, D, dtype,
               causal, kDq, scale, static_cast<cudaStream_t>(stream)};
  return launch(a);
}

// The launch plan of a backward call (kind 1 = dQ, 2 = dK/dV), as
// ops/kernels.py::wide_bwd_plan computes it: out = {cluster size, grid x,
// y, z, threads a CTA, dynamic shared-memory bytes a CTA, clusters the card
// holds at once (cudaOccupancyMaxActiveClusters)}. Returns the cudaError of
// the query.
int pio_flash_attn_wide_bwd_plan(int B, int L, int H, int D, int dtype,
                                 int causal, int kind, int* out) {
  if (!takes(B, L, H, D, dtype, kind)) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, B,       L,       H,       D,
               dtype,   causal,  kind,    1.f,     nullptr};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan(a, &attr);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, kernel_of(dtype, causal, kind), &cfg);
  const int vals[7] = {(int)attr.val.clusterDim.x, (int)cfg.gridDim.x,
                       (int)cfg.gridDim.y, (int)cfg.gridDim.z,
                       (int)cfg.blockDim.x, (int)cfg.dynamicSmemBytes,
                       clusters};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}

}  // extern "C"
