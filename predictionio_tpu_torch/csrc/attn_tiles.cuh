// Tile helpers shared by the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu, flash_attn_wide_fwd.cu, flash_attn_wide.cu): 16-byte
// cp.async staging of [B, L, H, D] rows into shared memory, zero-filled
// past L and past D, the forward's f32 SIMT tile (its shape, the
// transposed Q stage, feature vectors) and ex2, the backward's f32 SIMT
// tile (S / dP blocks, the P / dS buffers, the gradient sums), the bf16
// tensor-core pieces (ldmatrix, mma.sync m16n8k16 with f32 sums, fragment
// addressing, the backward's two product shapes), and the wide kernels'
// thread-block cluster exchange (a reduce-scatter of partial f32 tiles
// through distributed shared memory).
// Each including file gets its own copy (anonymous namespace).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

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

// 4 bytes from src, or 4 zero bytes when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
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

__device__ __forceinline__ float lane4(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// the forward's softmax and f32 tiles (flash_attn.cu, flash_attn_wide_fwd.cu)

// 2^x by the SFU alone (ex2.approx.ftz: a result below 2^-126 is 0, which
// is nothing beside the row's largest weight, 1); exp2f adds a range test
// and two conditional multiplies around it
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keys per K/V tile: 64, and 32 at head dim 256 (shared memory)
template <int DP>
__host__ __device__ constexpr int tile_n() {
  return DP <= 128 ? 64 : 32;
}

// The f32 forward's SIMT tile: BM query rows a CTA of 256 threads, DP
// features, BN keys a K/V tile; Qt [DP][SX], the K/V ring [2][2][BN][SY]
// and P [BN][SX] in shared memory
template <int DP, int BM>
struct F32Fwd {
  static constexpr int TO = BM / 16;                  // rows per thread
  static constexpr int SX = BM + 4;                   // Qt and P rows
  static constexpr int SY = row_stride<float, DP>();  // K, V rows
  static constexpr int NF = DP / 16;                  // features per thread
  static constexpr int BN = tile_n<DP>();             // keys per tile
  static constexpr int NJ = BN / 16;                  // keys per thread
  static constexpr int kFloats = DP * SX + 4 * BN * SY + BN * SX;
};

// Stage query rows [q0, q0 + BM) transposed into qt[d * SX + r] (once per
// CTA, NT threads), zeros past L and past D; rows are the fastest index, so
// the shared stores of a warp are consecutive.
template <int DP, int BM, int NT>
__device__ __forceinline__ void stage_qt(float* qt, const float* __restrict__ q,
                                         long long base, long long rs, int q0,
                                         int L, int D) {
  using G = F32Fwd<DP, BM>;
  for (int idx = threadIdx.x; idx < BM * (DP / 4); idx += NT) {
    const int r = idx % BM, c = (idx / BM) * 4, row = q0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L && c < D)
      v = __ldg(reinterpret_cast<const float4*>(q + base + row * rs + c));
#pragma unroll
    for (int e = 0; e < 4; ++e) qt[(c + e) * G::SX + r] = lane4(v, e);
  }
}

template <int NF>
__device__ __forceinline__ void load_feats(float (&x)[NF], const float* p) {
  if constexpr (NF == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x, x[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < NF; e += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + e);
      x[e] = t.x, x[e + 1] = t.y, x[e + 2] = t.z, x[e + 3] = t.w;
    }
  }
}

template <int NF>
__device__ __forceinline__ void store_feats(float* p, const float (&x)[NF]) {
  if constexpr (NF == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int e = 0; e < NF; e += 4)
      *reinterpret_cast<float4*>(p + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16 fed by ldmatrix

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

// ---------------------------------------------------------------------------
// the backward's tiles (flash_attn_bwd.cu; flash_attn_wide.cu at DP 128)

// P = exp(s * scale - lse) as exp2(s * scale * log2(e) - lse * log2(e)):
// scale2 = scale * log2(e), one FFMA and the SFU's exp2
__device__ __forceinline__ float exp_lse(float s, float scale2, float lse) {
  return exp2f(fmaf(s, scale2, -lse * kLog2e));
}

// The f32 backward's SIMT tile at DP features: BO own rows a CTA of 256
// threads, BS streamed rows a step (64 up to head dim 128, 16 at 256,
// unless given)
template <int DP_, int BS_ = (DP_ <= 128 ? 64 : 16)>
struct F32Tile {
  static constexpr int DP = DP_;
  static constexpr int BO = DP <= 64 ? 128 : 64;  // own rows per CTA
  static constexpr int TO = BO / 16;              // own rows per thread
  static constexpr int SX = BO + 4;               // transposed / buffer rows
  static constexpr int SY = row_stride<float, DP>();  // row-major rows
  static constexpr int NF = DP / 16;              // features per thread
  static constexpr int BUFS = DP <= 64 ? 2 : 1;   // P and dS buffers
  static constexpr int BS = BS_;                  // streamed rows per step
  static constexpr int NJ = BS / 16;              // streamed rows per thread
};

// Thread roles of the f32 backward: own group og (rows og * TO + i), first
// streamed row sr (rows sr + 8 j of BS), feature group fg (features
// 4 fg + 64 c). Lanes 0-7 of a quarter-warp share og and take neighbouring
// sr / fg.
template <int BS>
struct F32Roles {
  int og, sr, fg;
  __device__ F32Roles() {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    og = (warp & 3) * 4 + (lane >> 3);
    sr = (warp >> 2) * (BS / 2) + (lane & 7);
    fg = (warp >> 2) * 8 + (lane & 7);
  }
};

// a[i][j] = sum_d xt[d][og * TO + i] * y[sr + 8 j][d]: the S / dP block of
// own rows og * TO + i and streamed rows sr + 8 j, features in order.
template <typename G>
__device__ __forceinline__ void st_dot(float (&a)[G::TO][G::NJ],
                                       const float* xt, const float* y,
                                       int og, int sr) {
#pragma unroll
  for (int d = 0; d < G::DP; d += 4) {
    float4 yv[G::NJ];
#pragma unroll
    for (int j = 0; j < G::NJ; ++j)
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
        for (int j = 0; j < G::NJ; ++j)
          a[i][j] = fmaf(xv[i], lane4(yv[j], c), a[i][j]);
    }
  }
}

// buf[(sr + 8 j) * SX + og * TO + i] = a[i][j]: a thread's block as 16-byte
// rows of the [streamed][own] buffer
template <typename G>
__device__ __forceinline__ void put_block(float* buf,
                                          const float (&a)[G::TO][G::NJ],
                                          int og, int sr) {
#pragma unroll
  for (int j = 0; j < G::NJ; ++j)
#pragma unroll
    for (int i = 0; i < G::TO; i += 4)
      *reinterpret_cast<float4*>(&buf[(sr + 8 * j) * G::SX + og * G::TO + i]) =
          make_float4(a[i][j], a[i + 1][j], a[i + 2][j], a[i + 3][j]);
}

// acc[i][4 c + e] += sum_r buf[r][og * TO + i] * y[r][4 fg + 64 c + e] over
// the streamed rows [R0, R1) in order: dV += P^T dO, dK += dS^T Q or
// dQ += dS K.
template <typename G, int R0 = 0, int R1 = G::BS>
__device__ __forceinline__ void buf_dot(float (&acc)[G::TO][G::NF],
                                        const float* buf, const float* y,
                                        int og, int fg) {
  constexpr int NC = G::DP / 64;
#pragma unroll 8
  for (int r = R0; r < R1; ++r) {
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

template <typename G>
__device__ __forceinline__ void write_f32(float* __restrict__ out,
                                          const float (&acc)[G::TO][G::NF],
                                          long long base, long long rs,
                                          int r0, int L, int D, int og,
                                          int fg) {
#pragma unroll
  for (int i = 0; i < G::TO; ++i) {
    const int row = r0 + og * G::TO + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < G::DP / 64; ++c) {
      const int f = 4 * fg + 64 * c;
      if (f < D)
        *reinterpret_cast<float4*>(&out[base + row * rs + f]) =
            make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                        acc[i][4 * c + 3]);
    }
  }
}

// acc[n] (16 x 8 tiles over the warp's rows r0..r0+15 and the streamed
// rows 8 n..8 n+7) += x[r0.., :DP] y[8 n.., :DP]^T, x and y row-major bf16
// tiles of DP features
template <int DP, int NS>
__device__ __forceinline__ void mma_rows(float (&acc)[NS][4], const bf16* x,
                                         const bf16* y, int r0) {
  constexpr int S = row_stride<bf16, DP>();
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
// a y[16 KQ0:16 KQ1, :DP], with a the bf16 A fragments of the warp's
// [16 x BS] P or dS (pa[n][0]: row g, streamed 8 n + 2 t and + 1; pa[n][1]:
// row g + 8), streamed rows in order
template <int DP, int BS, int KQ0 = 0, int KQ1 = BS / 16>
__device__ __forceinline__ void mma_feats(float (&acc)[DP / 8][4],
                                          const uint32_t (&pa)[BS / 8][2],
                                          const bf16* y) {
  constexpr int S = row_stride<bf16, DP>();
#pragma unroll
  for (int kq = KQ0; kq < KQ1; ++kq) {
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

// ---------------------------------------------------------------------------
// thread-block clusters (flash_attn_wide_fwd.cu, flash_attn_wide.cu)
//
// A cluster of n = D / 128 CTAs (3 to 8) splits the head dim into
// 128-feature slices, one a CTA, so a score tile S (and dP) it forms is a
// partial sum over its slice. Each CTA writes its partial f32 tile X
// ([line][S] floats, W of a line summed) to its shared memory; after a
// cluster barrier CTA r sums lines [own_start(r), own_start(r + 1)) of
// every CTA's X, in rank order 0, 1, ..., n - 1, into its own Y; after a
// second barrier every CTA reads each line's sum from its owner, so every
// CTA holds the same bits.

constexpr int kSlice = 128;      // features a CTA
constexpr int kMinCluster = 3;   // D 384
constexpr int kMaxCluster = 8;   // D 1024: the portable cluster size

// the first line of a LINES-line tile that rank r of an n-CTA cluster sums
template <int LINES>
__device__ __forceinline__ int own_start(int r, int n) {
  return LINES * r / n;
}

// the rank that sums line `line`: the r with own_start(r) <= line <
// own_start(r + 1)
template <int LINES>
__device__ __forceinline__ int owner_of(int line, int n) {
  return ((line + 1) * n + LINES - 1) / LINES - 1;
}

// Reduce-scatter of the cluster's partial tiles: this CTA sums lines
// [own_start(rank), own_start(rank + 1)) of every CTA's X, in rank order,
// into its own Y (line 0 of Y is its first line). X and Y are [line][S];
// the first W floats of a line (a multiple of 4) are summed.
template <int NT, int LINES, int S, int W>
__device__ __forceinline__ void sum_own_lines(cg::cluster_group& cluster,
                                              float* X, float* Y, int rank,
                                              int n) {
  const int la = own_start<LINES>(rank, n),
            lb = own_start<LINES>(rank + 1, n);
  for (int idx = threadIdx.x; idx < (lb - la) * (W / 4); idx += NT) {
    const int off = (la + idx / (W / 4)) * S + (idx % (W / 4)) * 4;
    float4 part[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < n)
        part[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(X, r) + off);
    float4 acc = part[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < n) {
        acc.x += part[r].x;
        acc.y += part[r].y;
        acc.z += part[r].z;
        acc.w += part[r].w;
      }
    *reinterpret_cast<float4*>(Y + off - la * S) = acc;
  }
}

// the cluster barrier in two halves: arrive (this thread's shared-memory
// writes released to the cluster) and wait (every thread of every CTA has
// arrived; their writes acquired). Every thread of a warp calls each
// together (.aligned).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the summed line `line`'s element `c` as its owner's Y holds it
template <int LINES, int S>
__device__ __forceinline__ const float* summed(cg::cluster_group& cluster,
                                               float* Y, int line, int c,
                                               int n) {
  const int r = owner_of<LINES>(line, n);
  return cluster.map_shared_rank(Y, r) + (line - own_start<LINES>(r, n)) * S +
         c;
}

}  // namespace
