// Exact flash-attention backward for Hopper (sm_90a): dK, dV and dQ of
// O = softmax(Q K^T * s) V from the forward's per-row logsumexp.
//
// Replaces the two backward Pallas TPU kernels of
// jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_dkv_kernel (dK, dV) and _flash_attention_dq_kernel (dQ),
// which that file's jax.custom_vjp calls when the seqrec model
// (predictionio_tpu/models/seq_attention.py) trains through
// predictionio_tpu/parallel/ring_attention.py::flash_attention. Same function
// as the plain version
// predictionio_tpu_torch/parallel/ring_attention.py::blockwise_attention_bwd:
// q, k, v, dO [B, L, H, D] (f32 or bf16, row-major, contiguous), lse and
// di = rowsum(dO * O) [B, H, L] f32, s = 1/sqrt(D), optional causal mask (key
// j visible to query i iff j <= i). For each visible pair
//   P = exp(S * s - lse),  dP = dO V^T,  dS = ((dP - di) * P) * s,
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K,
// with f32 products and sums. With bf16 inputs the products of bf16 values
// are exact in f32, and P and dS are rounded to bf16 (round to nearest even)
// before the products they feed (dV; dK and dQ), as the stock kernel casts
// them to the input type; dS is formed from the unrounded P. Outputs are in
// the input type. Masked pairs, keys and rows past L and padded features are
// masked before the exponential or staged as zeros, so they add exact zeros
// and never 0 * inf.
//
// What bounds it on the card: operations. dK/dV does 8*D FLOP per visible
// (query, key) pair (S, dP, dV, dK) and dQ 6*D (S, dP, dQ); at the seqrec
// training shape (B 8, L 4096, H 8, D 64, causal) that is 275 and 206 GFLOP
// against 50 MB of f32 in and out: thousands of FLOP per byte, far above the
// H100's ridge points (~20 FLOP/byte for f32 at 67 TFLOP/s, ~295 for bf16
// tensor cores). The bound is the FLOP count at the f32 CUDA-core peak for
// f32 inputs and at the bf16 tensor-core peak for bf16 inputs.
//
// Split. The TPU kernels carry dK/dV (or dQ) in VMEM scratch across a
// sequential grid axis. Here one CTA owns one output tile (the "own" axis)
// and walks the other (the "streamed" axis) itself, the TPU's split into two
// kernels: dK/dV owns keys and streams query tiles, from the first tile that
// reaches the diagonal under a causal mask; dQ owns queries and streams key
// tiles up to the diagonal. No atomics: each gradient element is written once
// by one CTA after a fixed summation order (feature 0 first, then the
// streamed rows in order), so the gradients are the same bits run to run.
// The heaviest tiles under the causal mask go first (the first key tiles for
// dK/dV, the last query tiles for dQ: the tile index is the slowest grid
// axis). dS is not written out: the seqrec model passes no attention bias.
//
// Staging, both types. The streamed tile (Q and dO with their lse and di
// rows for dK/dV; K and V for dQ), 64 rows (32 for bf16 at head dim 128; 16
// at head dim 256),
// goes through a two-stage ring in shared memory by 16-byte cp.async (4-byte
// for lse and di), zero-filled past L and past D: tile t + 1 loads while
// tile t computes, one __syncthreads a tile (two in f32, for the P and dS
// buffers). Rows are padded by 16 bytes, so the eight rows a quarter-warp
// (f32) or an ldmatrix phase (bf16) touches fall on distinct banks. No
// per-element division: chunk indices are shifts.
//
// f32 (the main path; CUDA-core FFMA, no TF32). 256 threads; the own tile is
// 128 rows at head dim <= 64 and 64 at 128 and 256 (registers), in 16
// groups of 8 (4) contiguous rows; the streamed tile's 64 rows in 16 groups
// of 4 interleaved rows (r, r + 8, r + 16, r + 24; one row of 16 at head
// dim 256), so the 8 lanes of a
// quarter-warp read 8 neighbouring rows (distinct banks) and one broadcast
// own row. Each thread holds an 8 x 4 block (4 x 4 at head dim 128) of S
// and of dP, like a SIMT SGEMM:
// - S (S^T = K Q^T for dK/dV, S = Q K^T for dQ) and dP take the own
//   operand transposed (feature-major, staged once per CTA) and the
//   streamed one row-major from the ring, four features of each streamed
//   row as one 16-byte vector: 12 vector loads per 128 FMAs.
// - P and dS go from registers through a shared [64][own] buffer each (one
//   buffer reused at head dim 128, for room) as 16-byte rows; then
//   dV += P^T dO and dK += dS^T Q (or dQ += dS K) read that buffer and the
//   streamed tile row-major: per streamed row 2 + 1 vector loads per 32
//   FMAs; each thread sums 8 (4) own rows x 4 (8) neighbouring features,
//   stored as 16-byte vectors. So Q and dO are only row-major in dK/dV's
//   ring and K only row-major in dQ's: no per-tile transpose.
// - The S / dP loop is unrolled whole and the sum loop by 8, which keeps the
//   D <= 64 kernels unspilled at 230-250 registers; one CTA per SM of 8
//   warps (shared memory at head dim 64 / 128: dK/dV 201 / 218 KB, dQ
//   167 / 217 KB).
//
// Both types: P = exp2(S * s * log2(e) - lse * log2(e)), one FFMA and the
// SFU's exp2 (accurate expf costs several more instructions a pair, which
// showed in the bf16 kernels' time); a tile whose pairs are all visible
// skips the mask.
//
// bf16 (tensor cores). 128 threads, 4 warps; the own tile is 64 rows, 16 a
// warp; mma.sync.m16n8k16 (bf16 in, f32 sums) for all five products, fed by
// ldmatrix from bf16 tiles in shared memory, head dim zero-padded to 64 or
// 128, or 256 (a multiple of the k-step 16):
// - dK/dV computes S^T = K Q^T and dP^T = V dO^T (K, V by ldmatrix as the
//   A operand, Q, dO as B), so P^T and dS^T come out in the accumulator
//   layout that m16n8k16 takes as its A operand; they are rounded to bf16
//   in registers and fed straight to dV += P^T dO and dK += dS^T Q, with Q
//   and dO read again as B by ldmatrix.trans: one row-major copy serves
//   both layouts, with no shared-memory round trip for P or dS.
// - dQ does the same with S = Q K^T, dP = dO V^T and dQ += dS K.
// - Shared memory at head dim 64 / 128: dK/dV 55 / 68.5 KB, dQ 54 / 68 KB;
//   the streamed tile is 32 rows at head dim 128 to hold registers.
//
// Head dim 256 (both types). A thread's share of dK and dV together (128
// f32 in f32, 256 in bf16) does not fit its registers, so the dK/dV kernel
// runs twice: once summing dV alone (S and P only), once dK alone (S, dP
// and dS), each CTA holding one accumulator; about 1.25x the products of
// one pass. dQ holds one accumulator anyway and runs once. The streamed
// tile is 16 rows, so the f32 kernels fit shared memory (~210 KB).

#include <math.h>

#include <type_traits>

#include "attn_tiles.cuh"

namespace {

constexpr int kTile = 64;        // own rows of a bf16 CTA
constexpr int kMaxTiles = 65535; // grid z limit (tiles of 64)

// ---------------------------------------------------------------------------
// f32: CUDA-core register tiles

constexpr int kF32Threads = 256;

template <int DP>
constexpr int f32_dkv_floats() {
  using G = F32Tile<DP>;
  // Kt, Vt; ring of 2 stages x (Q, dO); P / dS buffers; lse, di x 2 stages
  return 2 * DP * G::SX + 4 * G::BS * G::SY + G::BUFS * G::BS * G::SX +
         4 * G::BS;
}

template <int DP>
constexpr int f32_dq_floats() {
  using G = F32Tile<DP>;
  // Qt, dOt; ring of 2 stages x (K, V); the dS buffer
  return 2 * DP * G::SX + 4 * G::BS * G::SY + G::BS * G::SX;
}

// At head dim 256 one thread cannot hold both dK and dV: the dK/dV kernel
// runs twice, once for each (kOut 1 = dV, 2 = dK; 3 = both, below 256).
template <int DP>
constexpr bool split_dkv() {
  return DP > 128;
}

// Stage own rows [r0, r0 + BO) transposed into xt[d * SX + r] (once per
// CTA), zeros past L and past D; rows are the fastest index, so the shared
// stores of a warp are consecutive.
template <int DP>
__device__ __forceinline__ void stage_t(float* xt, const float* __restrict__ x,
                                        long long base, long long rs, int r0,
                                        int L, int D) {
  using G = F32Tile<DP>;
  for (int idx = threadIdx.x; idx < G::BO * (DP / 4); idx += kF32Threads) {
    const int r = idx % G::BO, c = (idx / G::BO) * 4, row = r0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L && c < D)
      v = __ldg(reinterpret_cast<const float4*>(x + base + row * rs + c));
#pragma unroll
    for (int e = 0; e < 4; ++e) xt[(c + e) * G::SX + r] = lane4(v, e);
  }
}

template <int DP, bool kCausal, int kOut>
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ dk, float* __restrict__ dv, int L, int H,
            int D, float scale) {
  using G = F32Tile<DP>;
  constexpr int BS = G::BS, NJ = G::NJ;
  constexpr bool kDV = kOut & 1, kDK = kOut & 2;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                          // Kt[d * SX + key]
  float* Vt = Kt + DP * G::SX;
  float* ring = Vt + DP * G::SX;             // [stage][Q, dO][query][SY]
  float* bufs = ring + 4 * BS * G::SY;       // [P, dS][query][SX]
  float* rows = bufs + G::BUFS * BS * G::SX; // [stage][lse, di][query]
  const F32Roles<BS> t;
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * G::BO;
  const long long rs = (long long)H * D;     // elements between positions
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * L;  // lse, di rows

  auto prefetch = [&](int q0, int st) {
    float* Qs = ring + 2 * st * BS * G::SY;
    stage_rows<float, DP, BS, kF32Threads>(Qs, q, base, rs, q0, L, D);
    stage_rows<float, DP, BS, kF32Threads>(Qs + BS * G::SY, dout, base, rs,
                                           q0, L, D);
    stage_vec<BS, kF32Threads>(rows + 2 * st * BS, lse, rbase, q0, L);
    stage_vec<BS, kF32Threads>(rows + (2 * st + 1) * BS, di, rbase, q0, L);
    cp_async_commit();
  };
  // under the causal mask no query before k0 sees this key tile
  const int q_begin = kCausal ? k0 : 0;
  prefetch(q_begin, 0);
  stage_t<DP>(Kt, k, base, rs, k0, L, D);
  stage_t<DP>(Vt, v, base, rs, k0, L, D);

  float adk[G::TO][G::NF], adv[G::TO][G::NF];
#pragma unroll
  for (int i = 0; i < G::TO; ++i)
#pragma unroll
    for (int c = 0; c < G::NF; ++c) adk[i][c] = adv[i][c] = 0.f;

  int st = 0;
  for (int q0 = q_begin; q0 < L; q0 += BS, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage and buffers are free
    if (q0 + BS < L) prefetch(q0 + BS, st ^ 1);
    const float* Qs = ring + 2 * st * BS * G::SY;
    const float* dOs = Qs + BS * G::SY;
    const float* lse_s = rows + 2 * st * BS;
    const float* di_s = lse_s + BS;

    // s[i][j], dp[i][j]: key k0 + og * TO + i, query q0 + sr + 8 j
    float s[G::TO][NJ], dp[G::TO][NJ];
#pragma unroll
    for (int i = 0; i < G::TO; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    st_dot<G>(s, Kt, Qs, t.og, t.sr);   // S^T = K Q^T
    if constexpr (kDK) st_dot<G>(dp, Vt, dOs, t.og, t.sr);  // dP^T = V dO^T
    // every pair of the tile visible: no mask
    const bool inner = q0 + BS <= L && k0 + G::BO <= L &&
                       (!kCausal || k0 + G::BO - 1 <= q0);
#pragma unroll
    for (int i = 0; i < G::TO; ++i) {
      const int key = k0 + t.og * G::TO + i;
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
    // P in bufs, dS in the second buffer (in bufs when it is the only one
    // and dV is not summed here)
    float* ds_buf = bufs + (kDV ? G::BUFS - 1 : 0) * BS * G::SX;
    if constexpr (kDV) put_block<G>(bufs, s, t.og, t.sr);
    if constexpr (kDK && (G::BUFS == 2 || !kDV))
      put_block<G>(ds_buf, dp, t.og, t.sr);
    __syncthreads();
    if constexpr (kDV) buf_dot<G>(adv, bufs, dOs, t.og, t.fg);  // dV += P^T dO
    if constexpr (kDK) {
      if constexpr (G::BUFS == 1 && kDV) {
        __syncthreads();
        put_block<G>(bufs, dp, t.og, t.sr);
        __syncthreads();
      }
      buf_dot<G>(adk, ds_buf, Qs, t.og, t.fg);  // dK += dS^T Q
    }
  }
  if constexpr (kDK) write_f32<G>(dk, adk, base, rs, k0, L, D, t.og, t.fg);
  if constexpr (kDV) write_f32<G>(dv, adv, base, rs, k0, L, D, t.og, t.fg);
}

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ di,
           float* __restrict__ dq, int L, int H, int D, float scale) {
  using G = F32Tile<DP>;
  constexpr int BS = G::BS, NJ = G::NJ;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                          // Qt[d * SX + query]
  float* dOt = Qt + DP * G::SX;
  float* ring = dOt + DP * G::SX;            // [stage][K, V][key][SY]
  float* buf = ring + 4 * BS * G::SY;        // dS [key][SX]
  const F32Roles<BS> t;
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * G::BO;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * L;
  const int kv_end = kCausal ? min(L, q0 + G::BO) : L;

  auto prefetch = [&](int k0, int st) {
    float* Ks = ring + 2 * st * BS * G::SY;
    stage_rows<float, DP, BS, kF32Threads>(Ks, k, base, rs, k0, L, D);
    stage_rows<float, DP, BS, kF32Threads>(Ks + BS * G::SY, v, base, rs, k0,
                                           L, D);
    cp_async_commit();
  };
  prefetch(0, 0);
  stage_t<DP>(Qt, q, base, rs, q0, L, D);
  stage_t<DP>(dOt, dout, base, rs, q0, L, D);
  float lse_r[G::TO], di_r[G::TO];  // queries q0 + og * TO + i
#pragma unroll
  for (int i = 0; i < G::TO; ++i) {
    const int row = q0 + t.og * G::TO + i;
    lse_r[i] = row < L ? lse[rbase + row] : 0.f;
    di_r[i] = row < L ? di[rbase + row] : 0.f;
  }

  float acc[G::TO][G::NF];
#pragma unroll
  for (int i = 0; i < G::TO; ++i)
#pragma unroll
    for (int c = 0; c < G::NF; ++c) acc[i][c] = 0.f;

  int st = 0;
  for (int k0 = 0; k0 < kv_end; k0 += BS, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage and dS are free
    if (k0 + BS < kv_end) prefetch(k0 + BS, st ^ 1);
    const float* Ks = ring + 2 * st * BS * G::SY;
    const float* Vs = Ks + BS * G::SY;

    // s[i][j], dp[i][j]: query q0 + og * TO + i, key k0 + sr + 8 j
    float s[G::TO][NJ], dp[G::TO][NJ];
#pragma unroll
    for (int i = 0; i < G::TO; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.f;
    st_dot<G>(s, Qt, Ks, t.og, t.sr);    // S = Q K^T
    st_dot<G>(dp, dOt, Vs, t.og, t.sr);  // dP = dO V^T
    const bool inner = q0 + G::BO <= L && k0 + BS <= L &&
                       (!kCausal || k0 + BS - 1 <= q0);
#pragma unroll
    for (int i = 0; i < G::TO; ++i) {
      const int row = q0 + t.og * G::TO + i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = k0 + t.sr + 8 * j;
        const bool ok =
            inner || (row < L && col < L && (!kCausal || col <= row));
        const float pf = ok ? exp_lse(s[i][j], scale2, lse_r[i]) : 0.f;
        dp[i][j] = (dp[i][j] - di_r[i]) * pf * scale;
      }
    }
    put_block<G>(buf, dp, t.og, t.sr);
    __syncthreads();
    buf_dot<G>(acc, buf, Ks, t.og, t.fg);  // dQ += dS K
  }
  write_f32<G>(dq, acc, base, rs, q0, L, D, t.og, t.fg);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16 fed by ldmatrix

constexpr int kBf16Threads = 128;

template <int DP>
struct Bf16Tile {
  // streamed rows per step
  static constexpr int BS = DP <= 64 ? 64 : DP <= 128 ? 32 : 16;
  static constexpr int SB = row_stride<bf16, DP>();  // row-major rows
};

template <int DP>
constexpr int bf16_dkv_bytes() {
  using G = Bf16Tile<DP>;
  // K, V; ring of 2 stages x (Q, dO); lse, di x 2 stages
  return (2 * kTile + 4 * G::BS) * G::SB * 2 + 4 * G::BS * 4;
}

template <int DP>
constexpr int bf16_dq_bytes() {
  using G = Bf16Tile<DP>;
  return (2 * kTile + 4 * G::BS) * G::SB * 2;  // Q, dO; ring of (K, V)
}

template <int DP, bool kCausal, int kOut>
__global__ void __launch_bounds__(kBf16Threads)
bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H,
             int D, float scale) {
  using G = Bf16Tile<DP>;
  constexpr int BS = G::BS, NS = BS / 8, NF = DP / 8;
  constexpr bool kDV = kOut & 1, kDK = kOut & 2;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_b);  // [key][SB]
  bf16* Vs = Ks + kTile * G::SB;
  bf16* ring = Vs + kTile * G::SB;              // [stage][Q, dO][query][SB]
  float* rows = reinterpret_cast<float*>(ring + 4 * BS * G::SB);
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int kr = warp * 16;                     // this warp's keys in the tile
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kTile;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * L;

  auto prefetch = [&](int q0, int st) {
    bf16* Qs = ring + 2 * st * BS * G::SB;
    stage_rows<bf16, DP, BS, kBf16Threads>(Qs, q, base, rs, q0, L, D);
    stage_rows<bf16, DP, BS, kBf16Threads>(Qs + BS * G::SB, dout, base, rs,
                                           q0, L, D);
    stage_vec<BS, kBf16Threads>(rows + 2 * st * BS, lse, rbase, q0, L);
    stage_vec<BS, kBf16Threads>(rows + (2 * st + 1) * BS, di, rbase, q0, L);
    cp_async_commit();
  };
  stage_rows<bf16, DP, kTile, kBf16Threads>(Ks, k, base, rs, k0, L, D);
  stage_rows<bf16, DP, kTile, kBf16Threads>(Vs, v, base, rs, k0, L, D);
  const int q_begin = kCausal ? k0 : 0;
  prefetch(q_begin, 0);  // K and V travel in the first group

  float adk[NF][4], adv[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[f][e] = adv[f][e] = 0.f;

  int st = 0;
  for (int q0 = q_begin; q0 < L; q0 += BS, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage is free
    if (q0 + BS < L) prefetch(q0 + BS, st ^ 1);
    const bf16* Qs = ring + 2 * st * BS * G::SB;
    const bf16* dOs = Qs + BS * G::SB;
    const float* lse_s = rows + 2 * st * BS;
    const float* di_s = lse_s + BS;

    // s[n][e], dp[n][e]: key k0 + kr + g + 8 (e / 2), query q0 + 8 n + 2 t
    // + e % 2
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows<DP, NS>(s, Ks, Qs, kr);                     // S^T = K Q^T
    if constexpr (kDK) mma_rows<DP, NS>(dp, Vs, dOs, kr);  // dP^T = V dO^T
    const bool inner = q0 + BS <= L && k0 + kTile <= L &&
                       (!kCausal || k0 + kTile - 1 <= q0);
    uint32_t pa[NS][2], da[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kr + g + 8 * (e >> 1);
        const int r = 8 * n + 2 * t + (e & 1), row = q0 + r;
        const bool ok =
            inner || (row < L && key < L && (!kCausal || key <= row));
        const float pf = ok ? exp_lse(s[n][e], scale2, lse_s[r]) : 0.f;
        s[n][e] = pf;
        dp[n][e] = (dp[n][e] - di_s[r]) * pf * scale;
      }
      pa[n][0] = pack_bf16(s[n][0], s[n][1]);
      pa[n][1] = pack_bf16(s[n][2], s[n][3]);
      da[n][0] = pack_bf16(dp[n][0], dp[n][1]);
      da[n][1] = pack_bf16(dp[n][2], dp[n][3]);
    }
    if constexpr (kDV) mma_feats<DP, BS>(adv, pa, dOs);  // dV += P^T dO
    if constexpr (kDK) mma_feats<DP, BS>(adk, da, Qs);   // dK += dS^T Q
  }
  if constexpr (kDK) write_bf16<DP>(dk, adk, base, rs, k0 + kr, L, D);
  if constexpr (kDV) write_bf16<DP>(dv, adv, base, rs, k0 + kr, L, D);
}

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kBf16Threads)
bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            bf16* __restrict__ dq, int L, int H, int D, float scale) {
  using G = Bf16Tile<DP>;
  constexpr int BS = G::BS, NS = BS / 8, NF = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_b);  // [query][SB]
  bf16* dOs = Qs + kTile * G::SB;
  bf16* ring = dOs + kTile * G::SB;             // [stage][K, V][key][SB]
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int qr = warp * 16;                     // this warp's queries
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * L;
  const int kv_end = kCausal ? min(L, q0 + kTile) : L;

  auto prefetch = [&](int k0, int st) {
    bf16* Ks = ring + 2 * st * BS * G::SB;
    stage_rows<bf16, DP, BS, kBf16Threads>(Ks, k, base, rs, k0, L, D);
    stage_rows<bf16, DP, BS, kBf16Threads>(Ks + BS * G::SB, v, base, rs, k0,
                                           L, D);
    cp_async_commit();
  };
  stage_rows<bf16, DP, kTile, kBf16Threads>(Qs, q, base, rs, q0, L, D);
  stage_rows<bf16, DP, kTile, kBf16Threads>(dOs, dout, base, rs, q0, L, D);
  prefetch(0, 0);  // Q and dO travel in the first group
  float lse_r[2], di_r[2];  // queries q0 + qr + g and + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + qr + g + 8 * half;
    lse_r[half] = row < L ? lse[rbase + row] : 0.f;
    di_r[half] = row < L ? di[rbase + row] : 0.f;
  }

  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;

  int st = 0;
  for (int k0 = 0; k0 < kv_end; k0 += BS, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage is free
    if (k0 + BS < kv_end) prefetch(k0 + BS, st ^ 1);
    const bf16* Ks = ring + 2 * st * BS * G::SB;
    const bf16* Vs = Ks + BS * G::SB;

    // s[n][e], dp[n][e]: query q0 + qr + g + 8 (e / 2), key k0 + 8 n + 2 t
    // + e % 2
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows<DP, NS>(s, Qs, Ks, qr);    // S = Q K^T
    mma_rows<DP, NS>(dp, dOs, Vs, qr);  // dP = dO V^T
    const bool inner = q0 + kTile <= L && k0 + BS <= L &&
                       (!kCausal || k0 + BS - 1 <= q0);
    uint32_t da[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + qr + g + 8 * (e >> 1);
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        const bool ok =
            inner || (row < L && col < L && (!kCausal || col <= row));
        const float pf = ok ? exp_lse(s[n][e], scale2, lse_r[e >> 1]) : 0.f;
        dp[n][e] = (dp[n][e] - di_r[e >> 1]) * pf * scale;
      }
      da[n][0] = pack_bf16(dp[n][0], dp[n][1]);
      da[n][1] = pack_bf16(dp[n][2], dp[n][3]);
    }
    mma_feats<DP, BS>(acc, da, Ks);  // dQ += dS K
  }
  write_bf16<DP>(dq, acc, base, rs, q0 + qr, L, D);
}

// ---------------------------------------------------------------------------
// launch

template <int DP, int kOut>
cudaError_t set_smem_dkv() {
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int f = f32_dkv_floats<DP>() * (int)sizeof(float);
  const int b = bf16_dkv_bytes<DP>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_dkv_f32<DP, false, kOut>, attr, f)) ||
      (err = cudaFuncSetAttribute(bwd_dkv_f32<DP, true, kOut>, attr, f)) ||
      (err = cudaFuncSetAttribute(bwd_dkv_bf16<DP, false, kOut>, attr, b)) ||
      (err = cudaFuncSetAttribute(bwd_dkv_bf16<DP, true, kOut>, attr, b)))
    return err;
  return cudaSuccess;
}

template <int DP>
cudaError_t set_smem_dp() {
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int f_dq = f32_dq_floats<DP>() * (int)sizeof(float);
  const int b_dq = bf16_dq_bytes<DP>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_dq_f32<DP, false>, attr, f_dq)) ||
      (err = cudaFuncSetAttribute(bwd_dq_f32<DP, true>, attr, f_dq)) ||
      (err = cudaFuncSetAttribute(bwd_dq_bf16<DP, false>, attr, b_dq)) ||
      (err = cudaFuncSetAttribute(bwd_dq_bf16<DP, true>, attr, b_dq)))
    return err;
  if constexpr (split_dkv<DP>()) {
    if ((err = set_smem_dkv<DP, 1>())) return err;
    return set_smem_dkv<DP, 2>();
  } else {
    return set_smem_dkv<DP, 3>();
  }
}

// the dK/dV kernel's outputs as a type (kOut), for the launch lambdas
template <int N>
using Out = std::integral_constant<int, N>;

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dk, *dv, *dq;  // dk and dv for the dK/dV kernel, dq for the dQ kernel
  int B, L, H, D, causal;
  float scale;
  cudaStream_t stream;
};

template <int DP, bool kCausal>
void launch_f32(const Args& a, bool dkv) {
  using G = F32Tile<DP>;
  const dim3 grid(a.H, a.B, (a.L + G::BO - 1) / G::BO);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* o = static_cast<const float*>(a.dout);
  auto dkv_out = [&](auto out) {
    bwd_dkv_f32<DP, kCausal, decltype(out)::value>
        <<<grid, kF32Threads, f32_dkv_floats<DP>() * sizeof(float),
           a.stream>>>(q, k, v, o, a.lse, a.di, static_cast<float*>(a.dk),
                       static_cast<float*>(a.dv), a.L, a.H, a.D, a.scale);
  };
  if (dkv) {
    if constexpr (split_dkv<DP>())
      dkv_out(Out<1>{}), dkv_out(Out<2>{});
    else
      dkv_out(Out<3>{});
  } else {
    bwd_dq_f32<DP, kCausal>
        <<<grid, kF32Threads, f32_dq_floats<DP>() * sizeof(float),
           a.stream>>>(q, k, v, o, a.lse, a.di, static_cast<float*>(a.dq),
                       a.L, a.H, a.D, a.scale);
  }
}

template <int DP, bool kCausal>
void launch_bf16(const Args& a, bool dkv) {
  const dim3 grid(a.H, a.B, (a.L + kTile - 1) / kTile);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* o = static_cast<const bf16*>(a.dout);
  auto dkv_out = [&](auto out) {
    bwd_dkv_bf16<DP, kCausal, decltype(out)::value>
        <<<grid, kBf16Threads, bf16_dkv_bytes<DP>(), a.stream>>>(
            q, k, v, o, a.lse, a.di, static_cast<bf16*>(a.dk),
            static_cast<bf16*>(a.dv), a.L, a.H, a.D, a.scale);
  };
  if (dkv) {
    if constexpr (split_dkv<DP>())
      dkv_out(Out<1>{}), dkv_out(Out<2>{});
    else
      dkv_out(Out<3>{});
  } else {
    bwd_dq_bf16<DP, kCausal>
        <<<grid, kBf16Threads, bf16_dq_bytes<DP>(), a.stream>>>(
            q, k, v, o, a.lse, a.di, static_cast<bf16*>(a.dq), a.L, a.H, a.D,
            a.scale);
  }
}

template <int DP>
cudaError_t launch(const Args& a, int dtype, bool dkv) {
  if (dtype == 0)
    a.causal ? launch_f32<DP, true>(a, dkv) : launch_f32<DP, false>(a, dkv);
  else
    a.causal ? launch_bf16<DP, true>(a, dkv) : launch_bf16<DP, false>(a, dkv);
  return cudaGetLastError();
}

int run(const Args& a, int dtype, bool dkv) {
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.D < 8 ||
      (a.D > 128 && a.D != 256) || a.D % 8 || a.B > 65535 || a.H > 65535 ||
      (a.L + kTile - 1) / kTile > kMaxTiles || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)(a.D <= 64    ? launch<64>(a, dtype, dkv)
               : a.D <= 128 ? launch<128>(a, dtype, dkv)
                            : launch<256>(a, dtype, dkv));
}

}  // namespace

extern "C" {

// Raise the dynamic shared-memory ceiling of every instantiation (once).
int pio_flash_attn_bwd_init() {
  cudaError_t err = set_smem_dp<64>();
  if (err == cudaSuccess) err = set_smem_dp<128>();
  if (err == cudaSuccess) err = set_smem_dp<256>();
  return (int)err;
}

// q, k, v, dout, dk, dv: [B, L, H, D] contiguous device buffers of one type
// (dtype 0 = f32, 1 = bf16), 16-byte aligned; lse, di: [B, H, L] f32.
// D a multiple of 8 from 8 to 128, or 256; L >= 1 and at most 65535 tiles of
// 64, B and H <= 65535 (the wrapper checks). Writes every element of dk and dv.
// Launches on `stream`; returns the cudaError of the launch.
int pio_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse, const void* di,
                           void* dk, void* dv, int B, int L, int H, int D,
                           int dtype, int causal, float scale,
                           void* stream_ptr) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dk, dv, nullptr, B, L, H, D,
               causal, scale, static_cast<cudaStream_t>(stream_ptr)};
  return run(a, dtype, true);
}

// As pio_flash_attn_bwd_dkv, writing every element of dq [B, L, H, D].
int pio_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse, const void* di,
                          void* dq, int B, int L, int H, int D, int dtype,
                          int causal, float scale, void* stream_ptr) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), nullptr, nullptr, dq, B, L, H,
               D, causal, scale, static_cast<cudaStream_t>(stream_ptr)};
  return run(a, dtype, false);
}

}  // extern "C"
