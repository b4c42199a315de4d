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
// rows for dK/dV; K and V for dQ), 64 rows (32 for bf16 at head dim 128),
// goes through a two-stage ring in shared memory by 16-byte cp.async (4-byte
// for lse and di), zero-filled past L and past D: tile t + 1 loads while
// tile t computes, one __syncthreads a tile (two in f32, for the P and dS
// buffers). Rows are padded by 16 bytes, so the eight rows a quarter-warp
// (f32) or an ldmatrix phase (bf16) touches fall on distinct banks. No
// per-element division: chunk indices are shifts.
//
// f32 (the main path; CUDA-core FFMA, no TF32). 256 threads; the own tile is
// 128 rows at head dim <= 64 and 64 at 128 (registers), in 16 groups of 8
// (4) contiguous rows; the streamed tile's 64 rows in 16 groups of 4
// interleaved rows (r, r + 8, r + 16, r + 24), so the 8 lanes of a
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
// 128 (a multiple of the k-step 16):
// - dK/dV computes S^T = K Q^T and dP^T = V dO^T (K, V by ldmatrix as the
//   A operand, Q, dO as B), so P^T and dS^T come out in the accumulator
//   layout that m16n8k16 takes as its A operand; they are rounded to bf16
//   in registers and fed straight to dV += P^T dO and dK += dS^T Q, with Q
//   and dO read again as B by ldmatrix.trans: one row-major copy serves
//   both layouts, with no shared-memory round trip for P or dS.
// - dQ does the same with S = Q K^T, dP = dO V^T and dQ += dS K.
// - Shared memory at head dim 64 / 128: dK/dV 55 / 68.5 KB, dQ 54 / 68 KB;
//   the streamed tile is 32 rows at head dim 128 to hold registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;        // own rows of a bf16 CTA; f32 streamed rows
constexpr int kMaxTiles = 65535; // grid z limit (tiles of 64)

// ---------------------------------------------------------------------------
// staging

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or 16 zero bytes when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row stride of a row-major tile: DP plus 16 bytes
template <typename T, int DP>
__host__ __device__ constexpr int row_stride() {
  return DP + 16 / (int)sizeof(T);
}

// Stage rows [r0, r0 + ROWS) of x [B, L, H, D] (this CTA's batch and head,
// `base` its first element, `rs` elements between positions) row-major into
// s[r * row_stride + d] by cp.async, zeros past L and past D.
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(T* s, const T* __restrict__ x,
                                           long long base, long long rs,
                                           int r0, int L, int D) {
  constexpr int kE = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  constexpr int kChunks = DP / kE;         // chunks per row: a power of two
  constexpr int kS = row_stride<T, DP>();
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += NT) {
    const int r = idx / kChunks, c = (idx % kChunks) * kE, row = r0 + r;
    const bool ok = row < L && c < D;
    cp_async16(s + r * kS + c, ok ? x + base + row * rs + c : x, ok);
  }
}

// Stage lse or di rows [r0, r0 + ROWS) by 4-byte cp.async, zeros past L.
template <int ROWS, int NT>
__device__ __forceinline__ void stage_vec(float* s,
                                          const float* __restrict__ x,
                                          long long rbase, int r0, int L) {
  for (int i = threadIdx.x; i < ROWS; i += NT) {
    const bool ok = r0 + i < L;
    cp_async4(s + i, ok ? x + rbase + r0 + i : x, ok);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core register tiles

constexpr int kF32Threads = 256;

template <int DP>
struct F32Tile {
  static constexpr int BO = DP <= 64 ? 128 : 64;  // own rows per CTA
  static constexpr int TO = BO / 16;              // own rows per thread
  static constexpr int SX = BO + 4;               // transposed / buffer rows
  static constexpr int SY = row_stride<float, DP>();  // row-major rows
  static constexpr int NF = DP / 16;              // features per thread
  static constexpr int BUFS = DP <= 64 ? 2 : 1;   // P and dS buffers
};

template <int DP>
constexpr int f32_dkv_floats() {
  using G = F32Tile<DP>;
  // Kt, Vt; ring of 2 stages x (Q, dO); P / dS buffers; lse, di x 2 stages
  return 2 * DP * G::SX + 4 * kTile * G::SY + G::BUFS * kTile * G::SX +
         4 * kTile;
}

template <int DP>
constexpr int f32_dq_floats() {
  using G = F32Tile<DP>;
  // Qt, dOt; ring of 2 stages x (K, V); the dS buffer
  return 2 * DP * G::SX + 4 * kTile * G::SY + kTile * G::SX;
}

constexpr float kLog2e = 1.4426950408889634f;

// P = exp(s * scale - lse) as exp2(s * scale * log2(e) - lse * log2(e)):
// scale2 = scale * log2(e), one FFMA and the SFU's exp2
__device__ __forceinline__ float exp_lse(float s, float scale2, float lse) {
  return exp2f(fmaf(s, scale2, -lse * kLog2e));
}

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
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

// a[i][j] = sum_d xt[d][og * TO + i] * y[sr + 8 j][d]: the S / dP block of
// own rows og * TO + i and streamed rows sr + 8 j, features in order.
template <int DP>
__device__ __forceinline__ void st_dot(float (&a)[F32Tile<DP>::TO][4],
                                       const float* xt, const float* y,
                                       int og, int sr) {
  using G = F32Tile<DP>;
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    float4 yv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      yv[j] = *reinterpret_cast<const float4*>(&y[(sr + 8 * j) * G::SY + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float xv[G::TO];
#pragma unroll
      for (int i = 0; i < G::TO; i += 4) {
        const float4 t = *reinterpret_cast<const float4*>(
            &xt[(d + c) * G::SX + og * G::TO + i]);
        xv[i] = t.x, xv[i + 1] = t.y, xv[i + 2] = t.z, xv[i + 3] = t.w;
      }
#pragma unroll
      for (int i = 0; i < G::TO; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          a[i][j] = fmaf(xv[i], lane4(yv[j], c), a[i][j]);
    }
  }
}

// buf[(sr + 8 j) * SX + og * TO + i] = a[i][j]: a thread's block as 16-byte
// rows of the [streamed][own] buffer
template <int DP>
__device__ __forceinline__ void put_block(float* buf,
                                          const float (&a)[F32Tile<DP>::TO][4],
                                          int og, int sr) {
  using G = F32Tile<DP>;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < G::TO; i += 4)
      *reinterpret_cast<float4*>(&buf[(sr + 8 * j) * G::SX + og * G::TO + i]) =
          make_float4(a[i][j], a[i + 1][j], a[i + 2][j], a[i + 3][j]);
}

// acc[i][4 c + e] += sum_r buf[r][og * TO + i] * y[r][4 fg + 64 c + e] over
// the 64 streamed rows in order: dV += P^T dO, dK += dS^T Q or dQ += dS K.
template <int DP>
__device__ __forceinline__ void buf_dot(float (&acc)[F32Tile<DP>::TO][DP / 16],
                                        const float* buf, const float* y,
                                        int og, int fg) {
  using G = F32Tile<DP>;
  constexpr int NC = DP / 64;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    float xv[G::TO];
#pragma unroll
    for (int i = 0; i < G::TO; i += 4) {
      const float4 t =
          *reinterpret_cast<const float4*>(&buf[r * G::SX + og * G::TO + i]);
      xv[i] = t.x, xv[i + 1] = t.y, xv[i + 2] = t.z, xv[i + 3] = t.w;
    }
    float4 yv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      yv[c] =
          *reinterpret_cast<const float4*>(&y[r * G::SY + 4 * fg + 64 * c]);
#pragma unroll
    for (int i = 0; i < G::TO; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][4 * c + e] = fmaf(xv[i], lane4(yv[c], e), acc[i][4 * c + e]);
  }
}

template <int DP>
__device__ __forceinline__ void write_f32(
    float* __restrict__ out, const float (&acc)[F32Tile<DP>::TO][DP / 16],
    long long base, long long rs, int r0, int L, int D, int og, int fg) {
  using G = F32Tile<DP>;
#pragma unroll
  for (int i = 0; i < G::TO; ++i) {
    const int row = r0 + og * G::TO + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < DP / 64; ++c) {
      const int f = 4 * fg + 64 * c;
      if (f < D)
        *reinterpret_cast<float4*>(&out[base + row * rs + f]) =
            make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                        acc[i][4 * c + 3]);
    }
  }
}

// Thread roles of the f32 kernels: own group og (rows og * TO + i), first
// streamed row sr (rows sr + 8 j), feature group fg (features 4 fg + 64 c).
// Lanes 0-7 of a quarter-warp share og and take neighbouring sr / fg.
struct F32Roles {
  int og, sr, fg;
  __device__ F32Roles() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    og = (warp & 3) * 4 + (lane >> 3);
    sr = (warp >> 2) * 32 + (lane & 7);
    fg = (warp >> 2) * 8 + (lane & 7);
  }
};

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ di,
            float* __restrict__ dk, float* __restrict__ dv, int L, int H,
            int D, float scale) {
  using G = F32Tile<DP>;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                          // Kt[d * SX + key]
  float* Vt = Kt + DP * G::SX;
  float* ring = Vt + DP * G::SX;             // [stage][Q, dO][query][SY]
  float* bufs = ring + 4 * kTile * G::SY;    // [P, dS][query][SX]
  float* rows = bufs + G::BUFS * kTile * G::SX;  // [stage][lse, di][query]
  const F32Roles t;
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * G::BO;
  const long long rs = (long long)H * D;     // elements between positions
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * L;  // lse, di rows

  auto prefetch = [&](int q0, int st) {
    float* Qs = ring + 2 * st * kTile * G::SY;
    stage_rows<float, DP, kTile, kF32Threads>(Qs, q, base, rs, q0, L, D);
    stage_rows<float, DP, kTile, kF32Threads>(Qs + kTile * G::SY, dout, base,
                                              rs, q0, L, D);
    stage_vec<kTile, kF32Threads>(rows + 2 * st * kTile, lse, rbase, q0, L);
    stage_vec<kTile, kF32Threads>(rows + (2 * st + 1) * kTile, di, rbase, q0,
                                  L);
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
  for (int q0 = q_begin; q0 < L; q0 += kTile, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage and buffers are free
    if (q0 + kTile < L) prefetch(q0 + kTile, st ^ 1);
    const float* Qs = ring + 2 * st * kTile * G::SY;
    const float* dOs = Qs + kTile * G::SY;
    const float* lse_s = rows + 2 * st * kTile;
    const float* di_s = lse_s + kTile;

    // s[i][j], dp[i][j]: key k0 + og * TO + i, query q0 + sr + 8 j
    float s[G::TO][4], dp[G::TO][4];
#pragma unroll
    for (int i = 0; i < G::TO; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    st_dot<DP>(s, Kt, Qs, t.og, t.sr);   // S^T = K Q^T
    st_dot<DP>(dp, Vt, dOs, t.og, t.sr); // dP^T = V dO^T
    // every pair of the tile visible: no mask
    const bool inner = q0 + kTile <= L && k0 + G::BO <= L &&
                       (!kCausal || k0 + G::BO - 1 <= q0);
#pragma unroll
    for (int i = 0; i < G::TO; ++i) {
      const int key = k0 + t.og * G::TO + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = t.sr + 8 * j, row = q0 + r;
        const bool ok =
            inner || (row < L && key < L && (!kCausal || key <= row));
        const float pf = ok ? exp_lse(s[i][j], scale2, lse_s[r]) : 0.f;
        s[i][j] = pf;
        dp[i][j] = (dp[i][j] - di_s[r]) * pf * scale;
      }
    }
    put_block<DP>(bufs, s, t.og, t.sr);
    if constexpr (G::BUFS == 2)
      put_block<DP>(bufs + kTile * G::SX, dp, t.og, t.sr);
    __syncthreads();
    buf_dot<DP>(adv, bufs, dOs, t.og, t.fg);  // dV += P^T dO
    if constexpr (G::BUFS == 1) {
      __syncthreads();
      put_block<DP>(bufs, dp, t.og, t.sr);
      __syncthreads();
    }
    buf_dot<DP>(adk, bufs + (G::BUFS - 1) * kTile * G::SX, Qs, t.og,
                t.fg);  // dK += dS^T Q
  }
  write_f32<DP>(dk, adk, base, rs, k0, L, D, t.og, t.fg);
  write_f32<DP>(dv, adv, base, rs, k0, L, D, t.og, t.fg);
}

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kF32Threads, 1)
bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ di,
           float* __restrict__ dq, int L, int H, int D, float scale) {
  using G = F32Tile<DP>;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                          // Qt[d * SX + query]
  float* dOt = Qt + DP * G::SX;
  float* ring = dOt + DP * G::SX;            // [stage][K, V][key][SY]
  float* buf = ring + 4 * kTile * G::SY;     // dS [key][SX]
  const F32Roles t;
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * G::BO;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * L;
  const int kv_end = kCausal ? min(L, q0 + G::BO) : L;

  auto prefetch = [&](int k0, int st) {
    float* Ks = ring + 2 * st * kTile * G::SY;
    stage_rows<float, DP, kTile, kF32Threads>(Ks, k, base, rs, k0, L, D);
    stage_rows<float, DP, kTile, kF32Threads>(Ks + kTile * G::SY, v, base, rs,
                                              k0, L, D);
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
  for (int k0 = 0; k0 < kv_end; k0 += kTile, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage and dS are free
    if (k0 + kTile < kv_end) prefetch(k0 + kTile, st ^ 1);
    const float* Ks = ring + 2 * st * kTile * G::SY;
    const float* Vs = Ks + kTile * G::SY;

    // s[i][j], dp[i][j]: query q0 + og * TO + i, key k0 + sr + 8 j
    float s[G::TO][4], dp[G::TO][4];
#pragma unroll
    for (int i = 0; i < G::TO; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    st_dot<DP>(s, Qt, Ks, t.og, t.sr);    // S = Q K^T
    st_dot<DP>(dp, dOt, Vs, t.og, t.sr);  // dP = dO V^T
    const bool inner = q0 + G::BO <= L && k0 + kTile <= L &&
                       (!kCausal || k0 + kTile - 1 <= q0);
#pragma unroll
    for (int i = 0; i < G::TO; ++i) {
      const int row = q0 + t.og * G::TO + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + t.sr + 8 * j;
        const bool ok =
            inner || (row < L && col < L && (!kCausal || col <= row));
        const float pf = ok ? exp_lse(s[i][j], scale2, lse_r[i]) : 0.f;
        dp[i][j] = (dp[i][j] - di_r[i]) * pf * scale;
      }
    }
    put_block<DP>(buf, dp, t.og, t.sr);
    __syncthreads();
    buf_dot<DP>(acc, buf, Ks, t.og, t.fg);  // dQ += dS K
  }
  write_f32<DP>(dq, acc, base, rs, q0, L, D, t.og, t.fg);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16 fed by ldmatrix

constexpr int kBf16Threads = 128;

template <int DP>
struct Bf16Tile {
  static constexpr int BS = DP <= 64 ? 64 : 32;  // streamed rows per step
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a b for one 16 x 8 tile: a 16 x 16 (row), b 16 x 8 (col), f32 sums
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix.x4 addresses of lane l (matrix m = l / 8, row l % 8) in a
// row-major tile x of stride S:
// - the A operand: rows r0..r0+15, k columns c0..c0+15;
__device__ __forceinline__ const bf16* a_frag(const bf16* x, int S, int r0,
                                              int c0) {
  const int l = threadIdx.x & 31, m = l >> 3;
  return x + (r0 + (m & 1) * 8 + (l & 7)) * S + c0 + (m >> 1) * 8;
}
// - the B operands of two n-tiles whose n index is the row (n0..n0+15), k
//   the column (c0..c0+15): regs {0, 1} n-tile n0, {2, 3} n-tile n0 + 8;
__device__ __forceinline__ const bf16* b_frag(const bf16* x, int S, int n0,
                                              int c0) {
  const int l = threadIdx.x & 31, m = l >> 3;
  return x + (n0 + (m >> 1) * 8 + (l & 7)) * S + c0 + (m & 1) * 8;
}
// - with .trans, the B operands of two n-tiles whose k index is the row
//   (k0..k0+15), n the column (n0..n0+15): the same register order.
__device__ __forceinline__ const bf16* bt_frag(const bf16* x, int S, int k0,
                                               int n0) {
  const int l = threadIdx.x & 31, m = l >> 3;
  return x + (k0 + (m & 1) * 8 + (l & 7)) * S + n0 + (m >> 1) * 8;
}

// acc[n] (16 x 8 tiles over the warp's rows r0..r0+15 and the streamed
// rows 8 n..8 n+7) += x[r0.., :DP] y[8 n.., :DP]^T
template <int DP, int NS>
__device__ __forceinline__ void mma_rows(float (&acc)[NS][4], const bf16* x,
                                         const bf16* y, int r0) {
  constexpr int S = Bf16Tile<DP>::SB;
#pragma unroll
  for (int c0 = 0; c0 < DP; c0 += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_frag(x, S, r0, c0));
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
      uint32_t bb[4];
      ldsm_x4(bb, b_frag(y, S, n * 8, c0));
      mma16816(acc[n], a, bb[0], bb[1]);
      mma16816(acc[n + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[f] (16 x 8 tiles over the warp's rows and features 8 f..8 f+7) +=
// a y[:BS, :DP], with a the bf16 A fragments of the warp's [16 x BS] P or dS
// (pa[n][0]: row g, streamed 8 n + 2 t and + 1; pa[n][1]: row g + 8)
template <int DP, int BS>
__device__ __forceinline__ void mma_feats(float (&acc)[DP / 8][4],
                                          const uint32_t (&pa)[BS / 8][2],
                                          const bf16* y) {
  constexpr int S = Bf16Tile<DP>::SB;
#pragma unroll
  for (int kq = 0; kq < BS / 16; ++kq) {
    const uint32_t a[4] = {pa[2 * kq][0], pa[2 * kq][1], pa[2 * kq + 1][0],
                           pa[2 * kq + 1][1]};
#pragma unroll
    for (int f = 0; f < DP / 8; f += 2) {
      uint32_t bb[4];
      ldsm_x4_t(bb, bt_frag(y, S, kq * 16, f * 8));
      mma16816(acc[f], a, bb[0], bb[1]);
      mma16816(acc[f + 1], a, bb[2], bb[3]);
    }
  }
}

// rows r0 + g and r0 + g + 8 of a warp's [16 x DP] accumulator to out
template <int DP>
__device__ __forceinline__ void write_bf16(bf16* __restrict__ out,
                                           const float (&acc)[DP / 8][4],
                                           long long base, long long rs,
                                           int r0, int L, int D) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= L) continue;
#pragma unroll
    for (int f = 0; f < DP / 8; ++f) {
      const int col = 8 * f + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(&out[base + row * rs + col]) =
            __floats2bfloat162_rn(acc[f][2 * half], acc[f][2 * half + 1]);
    }
  }
}

template <int DP, bool kCausal>
__global__ void __launch_bounds__(kBf16Threads)
bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int L, int H,
             int D, float scale) {
  using G = Bf16Tile<DP>;
  constexpr int BS = G::BS, NS = BS / 8, NF = DP / 8;
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
    mma_rows<DP, NS>(s, Ks, Qs, kr);    // S^T = K Q^T
    mma_rows<DP, NS>(dp, Vs, dOs, kr);  // dP^T = V dO^T
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
    mma_feats<DP, BS>(adv, pa, dOs);  // dV += P^T dO
    mma_feats<DP, BS>(adk, da, Qs);   // dK += dS^T Q
  }
  write_bf16<DP>(dk, adk, base, rs, k0 + kr, L, D);
  write_bf16<DP>(dv, adv, base, rs, k0 + kr, L, D);
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

template <int DP>
cudaError_t set_smem_dp() {
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  const int f_dkv = f32_dkv_floats<DP>() * (int)sizeof(float);
  const int f_dq = f32_dq_floats<DP>() * (int)sizeof(float);
  const int b_dkv = bf16_dkv_bytes<DP>(), b_dq = bf16_dq_bytes<DP>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(bwd_dkv_f32<DP, false>, attr, f_dkv)) ||
      (err = cudaFuncSetAttribute(bwd_dkv_f32<DP, true>, attr, f_dkv)) ||
      (err = cudaFuncSetAttribute(bwd_dq_f32<DP, false>, attr, f_dq)) ||
      (err = cudaFuncSetAttribute(bwd_dq_f32<DP, true>, attr, f_dq)) ||
      (err = cudaFuncSetAttribute(bwd_dkv_bf16<DP, false>, attr, b_dkv)) ||
      (err = cudaFuncSetAttribute(bwd_dkv_bf16<DP, true>, attr, b_dkv)) ||
      (err = cudaFuncSetAttribute(bwd_dq_bf16<DP, false>, attr, b_dq)) ||
      (err = cudaFuncSetAttribute(bwd_dq_bf16<DP, true>, attr, b_dq)))
    return err;
  return cudaSuccess;
}

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
  if (dkv)
    bwd_dkv_f32<DP, kCausal>
        <<<grid, kF32Threads, f32_dkv_floats<DP>() * sizeof(float),
           a.stream>>>(q, k, v, o, a.lse, a.di, static_cast<float*>(a.dk),
                       static_cast<float*>(a.dv), a.L, a.H, a.D, a.scale);
  else
    bwd_dq_f32<DP, kCausal>
        <<<grid, kF32Threads, f32_dq_floats<DP>() * sizeof(float),
           a.stream>>>(q, k, v, o, a.lse, a.di, static_cast<float*>(a.dq),
                       a.L, a.H, a.D, a.scale);
}

template <int DP, bool kCausal>
void launch_bf16(const Args& a, bool dkv) {
  const dim3 grid(a.H, a.B, (a.L + kTile - 1) / kTile);
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* o = static_cast<const bf16*>(a.dout);
  if (dkv)
    bwd_dkv_bf16<DP, kCausal>
        <<<grid, kBf16Threads, bf16_dkv_bytes<DP>(), a.stream>>>(
            q, k, v, o, a.lse, a.di, static_cast<bf16*>(a.dk),
            static_cast<bf16*>(a.dv), a.L, a.H, a.D, a.scale);
  else
    bwd_dq_bf16<DP, kCausal>
        <<<grid, kBf16Threads, bf16_dq_bytes<DP>(), a.stream>>>(
            q, k, v, o, a.lse, a.di, static_cast<bf16*>(a.dq), a.L, a.H, a.D,
            a.scale);
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
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.D < 8 || a.D > 128 || a.D % 8 ||
      a.B > 65535 || a.H > 65535 || (a.L + kTile - 1) / kTile > kMaxTiles ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)(a.D <= 64 ? launch<64>(a, dtype, dkv)
                         : launch<128>(a, dtype, dkv));
}

}  // namespace

extern "C" {

// Raise the dynamic shared-memory ceiling of every instantiation (once).
int pio_flash_attn_bwd_init() {
  cudaError_t err = set_smem_dp<64>();
  if (err == cudaSuccess) err = set_smem_dp<128>();
  return (int)err;
}

// q, k, v, dout, dk, dv: [B, L, H, D] contiguous device buffers of one type
// (dtype 0 = f32, 1 = bf16), 16-byte aligned; lse, di: [B, H, L] f32.
// 8 <= D <= 128 with D % 8 == 0, L >= 1 and at most 65535 tiles of 64, B and
// H <= 65535 (the wrapper checks). Writes every element of dk and dv.
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
