// Exact flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * s) V.
//
// Replaces the Pallas TPU kernel
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_kernel,
// as reached from predictionio_tpu/parallel/ring_attention.py::flash_attention
// (the seqrec model's attention, predictionio_tpu/models/seq_attention.py).
// Same function as that kernel and as the plain version
// predictionio_tpu_torch/parallel/ring_attention.py::blockwise_attention:
// q, k, v [B, L, H, D] (f32 or bf16, row-major, contiguous), a scale s (the
// caller passes 1/sqrt of the head dim before any zero padding), optional
// causal mask (key j visible to query i iff j <= i), no key-padding mask,
// f32 running max / sum / accumulator, output in the input dtype. With bf16
// inputs the products are exact in f32 and the softmax weights P are rounded
// to bf16 before P V, as the plain version does; the row sum uses the
// unrounded P. With f32 inputs everything stays f32: CUDA-core FFMAs in a
// fixed order (feature 0 first, key 0 first), no TF32, no tensor cores.
//
// What bounds it on the card: operations. One call does 4*B*H*L*L*D FLOP
// (QK^T and PV), about half of that when causal (L(L+1)/2 visible pairs),
// against 4*B*L*H*D elements of input and output. At the seqrec shape
// (B 4, L 4096, H 8, D 64, causal) that is 68.7 GFLOP for 33.6 MB of bf16:
// about 2000 FLOP per byte, far above the H100's ~295 FLOP/byte (bf16 tensor
// cores, 989 TFLOP/s) and ~20 FLOP/byte (f32, 67 TFLOP/s) ridge points. The
// bound is therefore the FLOP count at the f32 peak for f32 inputs and at the
// bf16 tensor-core peak for bf16 inputs.
//
// Split. The TPU kernel walks the kv blocks of a query block in grid order,
// carrying m / l / acc in VMEM scratch across grid steps. Here one CTA owns
// one (head, batch, query tile) and walks the K/V tiles itself (64 keys, 32
// at head dim 256 for shared memory), up to
// the diagonal under a causal mask, so nothing crosses CTAs; the tile index
// is the slowest grid axis and runs backwards, so the heaviest causal query
// tiles are scheduled first.
//
// Staging, both types. The K and V tiles go through a two-stage ring in
// shared memory by 16-byte cp.async, zero-filled past L and past D (a zero
// source size): tile t + 1 loads while tile t computes. Rows are padded by
// 16 bytes, so the eight rows a quarter-warp (f32) or an ldmatrix phase
// (bf16) touches fall on distinct banks. D is a multiple of 8 up to 128, or
// 256 (the caller zero-pads other head dims), so every row is whole 16-byte
// chunks.
//
// Softmax, both types. The running row max m is kept in log2 units, the
// largest S * s * log2(e) (one rounded product of the raw maximum); P is
// exp2(S * s * log2(e) - m), one FFMA and the SFU's ex2, and the running
// sum and accumulator are rescaled by exp2 of the change in m (by exactly 1
// when m has not moved).
// A tile whose pairs are all visible (every key < L and, when causal, every
// key <= the tile's first row) skips the mask; only the diagonal tile and
// the ragged last tile test col <= row / col < L. Masked scores are -inf,
// so they add exact zeros; key 0 is visible to every row, so m is finite
// after the first tile.
//
// f32 (CUDA-core FFMA, no TF32). 256 threads; 128 query rows a CTA at head
// dim <= 64 (64 at head dim 128 and 256, for registers and shared memory,
// and for L <= 64, where one 64-row tile holds the sequence), in 16 groups
// of 8 (4) rows; a row group's 16 threads are 16 lanes of one warp, so the
// row max and sum are shuffles. Each thread holds an 8 x 4 (4 x 4; 4 x 2 at
// head dim 256) block of S over keys kg, kg + 16, kg + 32, kg + 48, like a
// SIMT SGEMM:
// - S = Q K^T takes Q transposed (feature-major, staged once per CTA) and K
//   row-major from the ring, four features of a key as one 16-byte vector:
//   12 vector loads per 128 FMAs.
// - P goes from registers to a shared [key][row] buffer as 16-byte rows;
//   then O += P V (unrolled whole) reads that buffer (broadcast) and V
//   row-major, each thread owning its rows x DP/16 neighbouring features
//   (16-byte vectors), so O lives in registers and is written once. A
//   warp's rows of P are written and read by that warp alone, so a warp
//   barrier orders them: one CTA barrier a tile, for the ring. (Passing P
//   by shuffles instead was slower on the card: 8 shuffles a key against 2
//   broadcast loads.)
//
// bf16 (tensor cores). 128 threads, 4 warps; 32 query rows a warp (two m16
// tiles, 128 a CTA) at head dim <= 64, so each K and V fragment read from
// shared memory feeds two products; 16 a warp at head dim 128 (registers)
// and for L <= 64. mma.sync.m16n8k16 (bf16 in, f32 sums) for both products,
// head dim zero-padded to 32, 64 or 128, or 256 (a multiple of the k-step
// 16). Q's fragments are loaded once by ldmatrix into registers (at head dim
// 256, where O's accumulator takes 128 registers a thread, once a k-step
// from the staged Q tile); S = Q K^T takes K
// by ldmatrix as the B operand. S comes out in the accumulator layout that
// m16n8k16 takes as its A operand, so P is rounded to bf16 in registers and
// fed straight to O += P V, with V read by ldmatrix.trans: no shared-memory
// round trip for P.
//
// Residual for the backward (csrc/flash_attn_bwd.cu). Given an lse buffer
// [B, H, L] f32, the kernel also writes each row's logsumexp m ln(2) +
// log(l), in natural-log units (the backward folds log2(e) in itself). The
// TPU kernel saves l and m as two buffers; one logsumexp gives the backward
// the same P with one load. Whether to write it is one test of the pointer in
// the epilogue, outside the output arithmetic: the serving path passes no
// buffer and its output bits are the same as with one.

#include <math.h>

#include "attn_tiles.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxTiles = 65535; // grid z limit (query tiles)

// ---------------------------------------------------------------------------
// f32: CUDA-core register tiles

constexpr int kF32Threads = 256;

template <int DP, int BM, bool kCausal>
__global__ void __launch_bounds__(kF32Threads, 1)
fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, float* __restrict__ o,
        float* __restrict__ lse, int L, int H, int D, float scale) {
  using G = F32Fwd<DP, BM>;
  constexpr int TO = G::TO, NF = G::NF, SX = G::SX, SY = G::SY;
  constexpr int BN = G::BN, NJ = G::NJ;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // Qt[d * SX + row]
  float* ring = Qt + DP * SX;             // [stage][K, V][key][SY]
  float* Pb = ring + 4 * BN * SY;         // Pb[key * SX + row]
  // row group og (rows og * TO + i) = 16 lanes of one warp; kg: keys
  // kg + 16 j of S, features kg * NF + e of O
  const int lane = threadIdx.x & 31;
  const int og = (threadIdx.x >> 5) * 2 + (lane >> 4), kg = lane & 15;
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;
  const long long rs = (long long)H * D;  // elements between positions
  const long long base = (long long)b * L * rs + (long long)h * D;
  const int kv_end = kCausal ? min(L, q0 + BM) : L;

  auto prefetch = [&](int k0, int st) {
    float* Ks = ring + 2 * st * BN * SY;
    stage_rows<float, DP, BN, kF32Threads>(Ks, k, base, rs, k0, L, D);
    stage_rows<float, DP, BN, kF32Threads>(Ks + BN * SY, v, base, rs, k0, L,
                                           D);
    cp_async_commit();
  };
  prefetch(0, 0);
  stage_qt<DP, BM, kF32Threads>(Qt, q, base, rs, q0, L, D);

  // m: the running row max of S * s * log2(e); lsum: this thread's part of l
  float acc[TO][NF], m[TO], lsum[TO];
#pragma unroll
  for (int i = 0; i < TO; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NF; ++e) acc[i][e] = 0.f;
  }

  int st = 0;
  for (int k0 = 0; k0 < kv_end; k0 += BN, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage and Pb are free
    if (k0 + BN < kv_end) prefetch(k0 + BN, st ^ 1);
    const float* Ks = ring + 2 * st * BN * SY;
    const float* Vs = Ks + BN * SY;

    // s[i][j]: row q0 + og * TO + i, key k0 + kg + 16 j
    float s[TO][NJ];
#pragma unroll
    for (int i = 0; i < TO; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      float4 kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(kg + 16 * j) * SY + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float qv[TO];
#pragma unroll
        for (int i = 0; i < TO; i += 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(&Qt[(d + c) * SX + og * TO + i]);
          qv[i] = t.x, qv[i + 1] = t.y, qv[i + 2] = t.z, qv[i + 3] = t.w;
        }
#pragma unroll
        for (int i = 0; i < TO; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            s[i][j] = fmaf(qv[i], lane4(kv[j], c), s[i][j]);
      }
    }
    // every pair of the tile visible: no mask
    const bool inner = k0 + BN <= L && (!kCausal || k0 + BN - 1 <= q0);
    if (!inner) {
#pragma unroll
      for (int i = 0; i < TO; ++i) {
        const int row = q0 + og * TO + i;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = k0 + kg + 16 * j;
          if (col >= L || (kCausal && col > row)) s[i][j] = -INFINITY;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TO; ++i) {
      float mt = fmaxf(s[i][0], s[i][1]);
      if constexpr (NJ == 4) mt = fmaxf(mt, fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], __fmul_rn(mt, scale2));
      const float m2 = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = m[i] == m2 ? 1.f : fast_exp2(m[i] - m2);
      m[i] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fast_exp2(fmaf(s[i][j], scale2, -m2));
        ps += s[i][j];
      }
      lsum[i] = fmaf(lsum[i], alpha, ps);
#pragma unroll
      for (int e = 0; e < NF; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int i = 0; i < TO; i += 4)
        *reinterpret_cast<float4*>(&Pb[(kg + 16 * j) * SX + og * TO + i]) =
            make_float4(s[i][j], s[i + 1][j], s[i + 2][j], s[i + 3][j]);
    // a warp's two row groups are its own 32 lanes: it writes and reads only
    // its own rows of Pb, so a warp barrier orders them
    __syncwarp();

#pragma unroll
    for (int r = 0; r < BN; ++r) {
      float pv[TO], vv[NF];
#pragma unroll
      for (int i = 0; i < TO; i += 4) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Pb[r * SX + og * TO + i]);
        pv[i] = t.x, pv[i + 1] = t.y, pv[i + 2] = t.z, pv[i + 3] = t.w;
      }
      load_feats<NF>(vv, &Vs[r * SY + kg * NF]);
#pragma unroll
      for (int i = 0; i < TO; ++i)
#pragma unroll
        for (int e = 0; e < NF; ++e) acc[i][e] = fmaf(pv[i], vv[e], acc[i][e]);
    }
  }

#pragma unroll
  for (int i = 0; i < TO; ++i) {
    float lt = lsum[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + og * TO + i;
    if (row >= L) continue;
    // every valid row sees a key (key 0 under the causal mask): lt > 0
    if (lse && kg == 0)
      lse[((long long)b * H + h) * L + row] = m[i] * kLn2 + logf(lt);
    const float den = fmaxf(lt, 1e-20f);
    float out[NF];
#pragma unroll
    for (int e = 0; e < NF; ++e) out[e] = acc[i][e] / den;
    if (kg * NF < D) store_feats<NF>(&o[base + row * rs + kg * NF], out);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16 fed by ldmatrix

constexpr int kBf16Threads = 128;

// MT m16 tiles a warp: 16 * MT query rows, 64 * MT a CTA
template <int DP, int MT>
constexpr int bf16_fwd_bytes() {
  // Q; ring of 2 stages x (K, V)
  return (64 * MT + 4 * tile_n<DP>()) * row_stride<bf16, DP>() * 2;
}

template <int DP, int MT, bool kCausal>
__global__ void __launch_bounds__(kBf16Threads)
fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
         const bf16* __restrict__ v, bf16* __restrict__ o,
         float* __restrict__ lse, int L, int H, int D, float scale) {
  constexpr int S = row_stride<bf16, DP>(), BN = tile_n<DP>(), NS = BN / 8,
                NF = DP / 8;
  constexpr int kRows = 64 * MT;
  // Q's fragments stay in registers up to head dim 128; at 256 the O
  // accumulator needs them, and each k-step reads its fragment again
  constexpr bool kHoldQ = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_b);  // [query][S]
  bf16* ring = Qs + kRows * S;                  // [stage][K, V][key][S]
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int qr = warp * 16 * MT;                // this warp's rows in the tile
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const int kv_end = kCausal ? min(L, q0 + kRows) : L;

  auto prefetch = [&](int k0, int st) {
    bf16* Ks = ring + 2 * st * BN * S;
    stage_rows<bf16, DP, BN, kBf16Threads>(Ks, k, base, rs, k0, L, D);
    stage_rows<bf16, DP, BN, kBf16Threads>(Ks + BN * S, v, base, rs, k0, L,
                                           D);
    cp_async_commit();
  };
  stage_rows<bf16, DP, kRows, kBf16Threads>(Qs, q, base, rs, q0, L, D);
  prefetch(0, 0);  // Q travels in the first group
  cp_async_wait_all();
  __syncthreads();
  static_assert(kHoldQ || MT == 1, "one m16 tile a warp at head dim 256");
  // this warp's Q rows as A fragments: all of them held, or one k-step's
  uint32_t qa[MT][kHoldQ ? DP / 16 : 1][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < (kHoldQ ? DP / 16 : 0); ++c)
      ldsm_x4(qa[mt][c], a_frag(Qs, S, qr + 16 * mt, 16 * c));

  // acc[mt][f]: rows qr + 16 mt + g (+ 8) x features 8 f + 2 t (+ 1); m: the
  // running max of S * s * log2(e) of those rows; lsum: this thread's part
  // of their sums
  float acc[MT][NF][4], m[MT][2], lsum[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    lsum[mt][0] = lsum[mt][1] = 0.f;
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][f][e] = 0.f;
  }

  int st = 0;
  for (int k0 = 0; k0 < kv_end; k0 += BN, st ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this tile landed; the other stage is free
    if (k0 + BN < kv_end) prefetch(k0 + BN, st ^ 1);
    const bf16* Ks = ring + 2 * st * BN * S;
    const bf16* Vs = Ks + BN * S;

    // s[mt][n][e]: row q0 + qr + 16 mt + g + 8 (e / 2), key k0 + 8 n + 2 t
    // + e % 2; each K fragment serves the warp's MT row tiles
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      if constexpr (!kHoldQ) ldsm_x4(qa[0][0], a_frag(Qs, S, qr, 16 * c));
      const int cq = kHoldQ ? c : 0;
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, b_frag(Ks, S, n * 8, 16 * c));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][n], qa[mt][cq], bb[0], bb[1]);
          mma16816(s[mt][n + 1], qa[mt][cq], bb[2], bb[3]);
        }
      }
    }
    const bool inner = k0 + BN <= L && (!kCausal || k0 + BN - 1 <= q0);
    if (!inner) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + qr + 16 * mt + g + 8 * (e >> 1);
            const int col = k0 + 8 * n + 2 * t + (e & 1);
            if (col >= L || (kCausal && col > row)) s[mt][n][e] = -INFINITY;
          }
    }
    uint32_t pa[MT][NS][2];  // P rounded to bf16: the A operand of P V
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float m2[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * half], s[mt][n][2 * half + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][half], __fmul_rn(mx, scale2));
        m2[half] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha =
            m[mt][half] == m2[half] ? 1.f : fast_exp2(m[mt][half] - m2[half]);
        m[mt][half] = m_new;
        lsum[mt][half] *= alpha;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          acc[mt][f][2 * half] *= alpha;
          acc[mt][f][2 * half + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][n][e] = fast_exp2(fmaf(s[mt][n][e], scale2, -m2[e >> 1]));
          lsum[mt][e >> 1] += s[mt][n][e];
        }
        pa[mt][n][0] = pack_bf16(s[mt][n][0], s[mt][n][1]);
        pa[mt][n][1] = pack_bf16(s[mt][n][2], s[mt][n][3]);
      }
    }
    // O += P V, each V fragment (ldmatrix.trans) serving the MT row tiles
#pragma unroll
    for (int kq = 0; kq < BN / 16; ++kq) {
#pragma unroll
      for (int f = 0; f < NF; f += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, bt_frag(Vs, S, kq * 16, f * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t a[4] = {pa[mt][2 * kq][0], pa[mt][2 * kq][1],
                                 pa[mt][2 * kq + 1][0], pa[mt][2 * kq + 1][1]};
          mma16816(acc[mt][f], a, bb[0], bb[1]);
          mma16816(acc[mt][f + 1], a, bb[2], bb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float lt = lsum[mt][half];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int row = q0 + qr + 16 * mt + g + 8 * half;
      if (lse && t == 0 && row < L)
        lse[((long long)b * H + h) * L + row] = m[mt][half] * kLn2 + logf(lt);
      const float den = fmaxf(lt, 1e-20f);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        acc[mt][f][2 * half] /= den;
        acc[mt][f][2 * half + 1] /= den;
      }
    }
    write_bf16<DP>(o, acc[mt], base, rs, q0 + qr + 16 * mt, L, D);
  }
}

// ---------------------------------------------------------------------------
// launch

template <int DP, int BM>
cudaError_t set_smem_f32() {
  const int bytes = F32Fwd<DP, BM>::kFloats * (int)sizeof(float);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(fwd_f32<DP, BM, false>, attr, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fwd_f32<DP, BM, true>, attr, bytes);
  return err;
}

template <int DP, int MT>
cudaError_t set_smem_bf16() {
  const int bytes = bf16_fwd_bytes<DP, MT>();
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = cudaFuncSetAttribute(fwd_bf16<DP, MT, false>, attr, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fwd_bf16<DP, MT, true>, attr, bytes);
  return err;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, L, H, D, causal;
  float scale;
  cudaStream_t stream;
};

template <int DP, int BM>
void launch_f32(const Args& a) {
  const dim3 grid(a.H, a.B, (a.L + BM - 1) / BM);
  const size_t smem = F32Fwd<DP, BM>::kFloats * sizeof(float);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* o = static_cast<float*>(a.o);
  if (a.causal)
    fwd_f32<DP, BM, true><<<grid, kF32Threads, smem, a.stream>>>(
        q, k, v, o, a.lse, a.L, a.H, a.D, a.scale);
  else
    fwd_f32<DP, BM, false><<<grid, kF32Threads, smem, a.stream>>>(
        q, k, v, o, a.lse, a.L, a.H, a.D, a.scale);
}

template <int DP, int MT>
void launch_bf16(const Args& a) {
  const dim3 grid(a.H, a.B, (a.L + 64 * MT - 1) / (64 * MT));
  const size_t smem = bf16_fwd_bytes<DP, MT>();
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  bf16* o = static_cast<bf16*>(a.o);
  if (a.causal)
    fwd_bf16<DP, MT, true><<<grid, kBf16Threads, smem, a.stream>>>(
        q, k, v, o, a.lse, a.L, a.H, a.D, a.scale);
  else
    fwd_bf16<DP, MT, false><<<grid, kBf16Threads, smem, a.stream>>>(
        q, k, v, o, a.lse, a.L, a.H, a.D, a.scale);
}

// The tile by shape: head dim padded to 32, 64 or 128, or 256 itself; 128
// query rows a CTA at head dim <= 64 unless one 64-row tile holds the
// sequence (L <= 64), else 64 (at head dim 128 and 256 for registers and,
// in f32, shared memory).
cudaError_t launch(const Args& a, int dtype) {
  const bool small = a.L <= 64;
  if (dtype == 0) {
    if (a.D <= 32)
      small ? launch_f32<32, 64>(a) : launch_f32<32, 128>(a);
    else if (a.D <= 64)
      small ? launch_f32<64, 64>(a) : launch_f32<64, 128>(a);
    else if (a.D <= 128)
      launch_f32<128, 64>(a);
    else
      launch_f32<256, 64>(a);
  } else {
    if (a.D <= 32)
      small ? launch_bf16<32, 1>(a) : launch_bf16<32, 2>(a);
    else if (a.D <= 64)
      small ? launch_bf16<64, 1>(a) : launch_bf16<64, 2>(a);
    else if (a.D <= 128)
      launch_bf16<128, 1>(a);
    else
      launch_bf16<256, 1>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Raise the dynamic shared-memory ceiling of every instantiation (once).
int pio_flash_attn_init() {
  cudaError_t err;
  if ((err = set_smem_f32<32, 64>()) || (err = set_smem_f32<32, 128>()) ||
      (err = set_smem_f32<64, 64>()) || (err = set_smem_f32<64, 128>()) ||
      (err = set_smem_f32<128, 64>()) || (err = set_smem_f32<256, 64>()) ||
      (err = set_smem_bf16<32, 1>()) || (err = set_smem_bf16<32, 2>()) ||
      (err = set_smem_bf16<64, 1>()) || (err = set_smem_bf16<64, 2>()) ||
      (err = set_smem_bf16<128, 1>()) || (err = set_smem_bf16<256, 1>()))
    return (int)err;
  return (int)cudaSuccess;
}

// q, k, v, o: [B, L, H, D] contiguous, 16-byte aligned device buffers of one
// type (dtype 0 = f32, 1 = bf16); D a multiple of 8 from 8 to 128, or 256;
// L >= 1 and at most 65535 query tiles of 64, B and H <= 65535 (the wrapper
// checks).
// lse: null, or a [B, H, L] f32 device buffer that receives each row's
// logsumexp. Launches on `stream`; returns the cudaError of the launch.
int pio_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, int L, int H, int D, int dtype,
                       int causal, float scale, void* stream_ptr) {
  if (B <= 0 || L <= 0 || H <= 0 || D < 8 || (D > 128 && D != 256) ||
      D % 8 || B > 65535 || H > 65535 || (L + 63) / 64 > kMaxTiles ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, L, H, D, causal,
               scale, static_cast<cudaStream_t>(stream_ptr)};
  return (int)launch(a, dtype);
}

}  // extern "C"
