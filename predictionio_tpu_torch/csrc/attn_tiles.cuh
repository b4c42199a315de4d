// Tile helpers shared by the flash-attention kernels (flash_attn.cu,
// flash_attn_bwd.cu, flash_attn_wide_fwd.cu): 16-byte cp.async staging of
// [B, L, H, D] rows into shared memory, zero-filled past L and past D, the
// forward's f32 SIMT tile (its shape, the transposed Q stage, feature
// vectors) and ex2, and the bf16 tensor-core pieces (ldmatrix, mma.sync
// m16n8k16 with f32 sums, fragment addressing).
// Each including file gets its own copy (anonymous namespace).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace
