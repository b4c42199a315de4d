// Exact attention forward for head dims 384 to 1,024 on Hopper (sm_90a):
// O = softmax(Q K^T * s) V with its logsumexp, as a thread-block cluster
// over 128-feature slices of the head dim.
//
// Replaces no TPU kernel. The JAX package answers these head dims with its
// plain blockwise_attention (predictionio_tpu/parallel/ring_attention.py::
// flash_attention sends every shape but D 64 and 128 there), so on a TPU
// they never reach a Pallas kernel. The port's rule is that a wrapper
// launches its kernel or raises on a CUDA tensor; this is what
// ops/kernels.py launches for 256 < D <= 1024 (the caller zero-pads the
// head dim to a multiple of 128, which is exact). The backward kernels of
// these head dims are in flash_attn_wide.cu and read the logsumexp this
// kernel writes. Same function as the plain version
// (parallel/ring_attention.py::blockwise_attention) and the narrow kernel
// (flash_attn.cu): q, k, v [B, L, H, D] (f32 or bf16, row-major,
// contiguous), the scale s of the caller's original head dim, an optional
// causal mask (key j visible to query i iff j <= i), f32 running max, sum
// and accumulator, the output in the input dtype. With bf16 inputs every
// product is exact in f32 and P is rounded to bf16 before P V; the row sum
// uses the unrounded P. With f32 inputs everything stays f32 on CUDA-core
// FFMAs: no TF32, no tensor cores.
//
// What bounds it on the card: operations. 4 * D FLOP per visible (query,
// key) pair against a few bytes a pair; the bound is that count at the f32
// peak for f32 and at the bf16 tensor-core peak for bf16.
//
// Split. Let n = D / 128 (3 to 8). One cluster of n CTAs takes one (batch,
// head, 64-row query tile); CTA r of the cluster owns features [128 r,
// 128 r + 128) of Q, K, V and O. The query tile is the slowest grid axis
// and runs backwards, so the heaviest causal tiles are scheduled first.
// Each CTA runs the narrow kernel's head-dim-128 tile loop on its slice
// (flash_attn.cu, F32Fwd<128, 64> and fwd_bf16<128, 1>), 64 keys a tile:
// its K and V slices go through two-stage rings in shared memory by
// 16-byte cp.async, K(t + 1) and V(t) loading while tile t computes.
// - f32: 256 threads, the Q slice staged feature-major once, S as SIMT
//   register tiles (each thread 4 rows x 4 keys), P through a shared
//   [key][row] buffer, O += P V in registers.
// - bf16: 128 threads, 16 query rows a warp, mma.sync m16n8k16 fed by
//   ldmatrix for both products, Q's fragments held in registers, P rounded
//   to bf16 in registers as the A operand of P V.
//
// The one step the narrow kernel does not have: a CTA's scores are partial
// sums over its 128 features, and every CTA needs the whole sum. Each CTA
// writes its partial 64 x 64 f32 score tile to shared memory (X); after a
// cluster barrier the sums are reduce-scattered through distributed shared
// memory: CTA r owns lines [64 r / n, 64 (r + 1) / n) of the tile (keys in
// f32, query rows in bf16) and adds the n partials of those lines in rank
// order 0, 1, ..., n - 1 into its own buffer (Y). After a second cluster
// barrier each CTA reads the whole sum back from the owners. Every CTA
// thus holds the same bits of S and computes the same running max, sum and
// P, with the narrow kernel's softmax: m in log2 units (the largest
// S * s * log2(e)), P = exp2(S * s * log2(e) - m) by the SFU, the sum and
// accumulator rescaled by exp2 of the change in m. (An all-reduce, every
// CTA reading every partial after one barrier, moves n / 2 times the
// bytes and was slower on the card at D 512.)
//
// Each barrier is split into its arrive and its wait, and a CTA does the
// previous tile's O += P V between them, half its keys in each window, so
// the FMA pipes work while the cluster meets. The accumulator therefore
// holds P V up to tile t - 1 when tile t's max rescales it; the last
// tile's P V runs after the loop. Two barriers a tile are enough: X is
// written again only after the second barrier of the tile before (every
// owner has read it), Y only after the first (every CTA has gathered from
// it); one more barrier before exit keeps each CTA's shared memory alive
// while the others read it.
//
// Each CTA writes its O slice; rank 0 writes the logsumexp m ln(2) +
// log(l) in natural-log units, as the narrow kernel does, when given a
// buffer; the output bits are the same with and without it.
//
// Determinism: no atomics, and every sum in one fixed order (features in
// increasing order within a slice, slices in rank order, keys in
// increasing tiles), so two runs give the same bits.

#include <math.h>

#include <type_traits>

#include "attn_tiles.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64;         // the score tile: query rows x keys
constexpr int kRows = kTile;      // query rows a cluster
constexpr int kKeys = kTile;      // keys a K/V tile
constexpr int kMaxTiles = 65535;  // grid z limit (query tiles)
// lines of the score tile the smallest cluster's CTA sums: ceil(64 / 3)
constexpr int kOwnMax = (kTile + kMinCluster - 1) / kMinCluster;

constexpr int kF32Threads = 256;
constexpr int kBf16Threads = 128;
// keys of the tile before whose P V runs in the first barrier's window;
// the rest run in the second's
constexpr int kPvInA = 32;

using F32 = F32Fwd<kSlice, kRows>;
static_assert(F32::BN == kKeys && F32::TO == 4 && F32::NJ == 4,
              "the f32 slice is the narrow kernel's D-128 tile");

// line strides of the exchanged f32 score tile: f32 stores it [key][row]
// (a thread's four rows as one 16-byte vector), bf16 [row][key] (the
// accumulator's two neighbouring keys as one 8-byte vector); the padding
// keeps each quarter (half) warp's stores on distinct banks
constexpr int kXF32 = kTile + 4;
constexpr int kXBf16 = kTile + 8;

// ---------------------------------------------------------------------------
// f32: CUDA-core register tiles

constexpr int kF32Floats = F32::kFloats + (kTile + kOwnMax) * kXF32;

template <bool kCausal>
__global__ void __launch_bounds__(kF32Threads, 1)
wide_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             float* __restrict__ lse, int L, int H, int D, float scale) {
  constexpr int TO = F32::TO, NF = F32::NF, SX = F32::SX, SY = F32::SY;
  constexpr int BN = F32::BN, NJ = F32::NJ;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                   // Qt[d * SX + row], this slice
  float* ring = Qt + kSlice * SX;     // [stage][K, V][key][SY]
  float* Pb = ring + 4 * BN * SY;     // Pb[key * SX + row]
  float* Xs = Pb + BN * SX;           // this CTA's partial S [key][kXF32]
  float* Ys = Xs + kTile * kXF32;     // the sums of its own keys
  // row group og (rows og * TO + i) = 16 lanes of one warp; kg: keys
  // kg + 16 j of S, features kg * NF + e of O's slice
  const int lane = threadIdx.x & 31;
  const int og = (threadIdx.x >> 5) * 2 + (lane >> 4), kg = lane & 15;
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x / n, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const long long rs = (long long)H * D;  // elements between positions
  const long long base =
      (long long)b * L * rs + (long long)h * D + rank * kSlice;
  const int kv_end = kCausal ? min(L, q0 + kRows) : L;

  // K and V each go through their own two-stage ring: K(t + 1) and V(t)
  // load while tile t's scores are formed, exchanged and summed
  float* Kr = ring;                // [stage][key][SY]
  float* Vr = ring + 2 * BN * SY;  // [stage][key][SY]
  auto load = [&](float* dst, const float* x, int k0) {
    stage_rows<float, kSlice, BN, kF32Threads>(dst, x, base, rs, k0, L,
                                               kSlice);
  };
  load(Kr, k, 0);
  cp_async_commit();
  stage_qt<kSlice, kRows, kF32Threads>(Qt, q, base, rs, q0, L, kSlice);

  float acc[TO][NF], m[TO], lsum[TO];
#pragma unroll
  for (int i = 0; i < TO; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NF; ++e) acc[i][e] = 0.f;
  }
  // O += P V over keys [R0, R1) of a tile, P from Pb, V from Vs
  auto pv = [&](const float* Vs, auto r0, auto r1) {
#pragma unroll
    for (int r = decltype(r0)::value; r < decltype(r1)::value; ++r) {
      float pr[TO], vv[NF];
      const float4 t =
          *reinterpret_cast<const float4*>(&Pb[r * SX + og * TO]);
      pr[0] = t.x, pr[1] = t.y, pr[2] = t.z, pr[3] = t.w;
      load_feats<NF>(vv, &Vs[r * SY + kg * NF]);
#pragma unroll
      for (int i = 0; i < TO; ++i)
#pragma unroll
        for (int e = 0; e < NF; ++e) acc[i][e] = fmaf(pr[i], vv[e], acc[i][e]);
    }
  };
  using Zero = std::integral_constant<int, 0>;
  using Split = std::integral_constant<int, kPvInA>;
  using End = std::integral_constant<int, BN>;

  const int tiles = (kv_end + BN - 1) / BN;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * BN;
    cp_async_wait_all();
    __syncthreads();  // K(t), V(t - 1) landed; K(t - 1), V(t - 2) consumed
    if (k0 + BN < kv_end) load(Kr + ((t + 1) & 1) * BN * SY, k, k0 + BN);
    load(Vr + (t & 1) * BN * SY, v, k0);
    cp_async_commit();
    const float* Ks = Kr + (t & 1) * BN * SY;
    const float* Vp = Vr + ((t + 1) & 1) * BN * SY;  // V(t - 1)

    // s[i][j]: row q0 + og * TO + i, key k0 + kg + 16 j; this slice's part
    float s[TO][NJ];
#pragma unroll
    for (int i = 0; i < TO; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < kSlice; d += 4) {
      float4 kv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(kg + 16 * j) * SY + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float qv[TO];
        const float4 u =
            *reinterpret_cast<const float4*>(&Qt[(d + c) * SX + og * TO]);
        qv[0] = u.x, qv[1] = u.y, qv[2] = u.z, qv[3] = u.w;
#pragma unroll
        for (int i = 0; i < TO; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            s[i][j] = fmaf(qv[i], lane4(kv[j], c), s[i][j]);
      }
    }

    // the whole S: partials out, reduce-scatter, sums back; P V of the
    // tile before runs while each barrier completes
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(&Xs[(kg + 16 * j) * kXF32 + og * TO]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    cluster_arrive();
    if (t > 0) pv(Vp, Zero(), Split());
    cluster_wait();  // every CTA's partial landed
    sum_own_lines<kF32Threads, kTile, kXF32, kTile>(cluster, Xs, Ys, rank,
                                                  n);
    cluster_arrive();
    if (t > 0) pv(Vp, Split(), End());
    cluster_wait();  // every owner's sums landed
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float4 u = *reinterpret_cast<const float4*>(
          summed<kTile, kXF32>(cluster, Ys, kg + 16 * j, og * TO, n));
      s[0][j] = u.x, s[1][j] = u.y, s[2][j] = u.z, s[3][j] = u.w;
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
    // the accumulator holds P V up to tile t - 1: rescaled to tile t's max
#pragma unroll
    for (int i = 0; i < TO; ++i) {
      float mt = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
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
    // a warp writes and reads only its own rows of Pb: its lanes are done
    // with tile t - 1's
    __syncwarp();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<float4*>(&Pb[(kg + 16 * j) * SX + og * TO]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncwarp();
  }
  cp_async_wait_all();
  __syncthreads();  // V of the last tile landed
  pv(Vr + ((tiles + 1) & 1) * BN * SY, Zero(), End());
  cluster.sync();  // no CTA leaves while another reads its Y

#pragma unroll
  for (int i = 0; i < TO; ++i) {
    float lt = lsum[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + og * TO + i;
    if (row >= L) continue;
    // every valid row sees a key (key 0 under the causal mask): lt > 0
    if (lse && rank == 0 && kg == 0)
      lse[((long long)b * H + h) * L + row] = m[i] * kLn2 + logf(lt);
    const float den = fmaxf(lt, 1e-20f);
    float out[NF];
#pragma unroll
    for (int e = 0; e < NF; ++e) out[e] = acc[i][e] / den;
    store_feats<NF>(&o[base + row * rs + kg * NF], out);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16 fed by ldmatrix

constexpr int kBS = row_stride<bf16, kSlice>();  // Q, K, V rows (bf16)
constexpr int kBf16Bytes =
    (kRows + 4 * kKeys) * kBS * 2 + (kTile + kOwnMax) * kXBf16 * 4;

template <bool kCausal>
__global__ void __launch_bounds__(kBf16Threads)
wide_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int L, int H, int D, float scale) {
  constexpr int S = kBS, BN = kKeys, NS = BN / 8, NF = kSlice / 8;
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_b);  // [query][S]
  bf16* ring = Qs + kRows * S;                  // [stage][K, V][key][S]
  float* Xs = reinterpret_cast<float*>(ring + 4 * BN * S);  // [row][kXBf16]
  float* Ys = Xs + kTile * kXBf16;  // the sums of its own rows
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int qr = warp * 16;  // this warp's rows in the tile
  const float scale2 = scale * kLog2e;

  const int h = blockIdx.x / n, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const long long rs = (long long)H * D;
  const long long base =
      (long long)b * L * rs + (long long)h * D + rank * kSlice;
  const int kv_end = kCausal ? min(L, q0 + kRows) : L;

  // K and V each go through their own two-stage ring: K(t + 1) and V(t)
  // load while tile t's scores are formed, exchanged and summed
  bf16* Kr = ring;               // [stage][key][S]
  bf16* Vr = ring + 2 * BN * S;  // [stage][key][S]
  auto load = [&](bf16* dst, const bf16* x, int k0) {
    stage_rows<bf16, kSlice, BN, kBf16Threads>(dst, x, base, rs, k0, L,
                                               kSlice);
  };
  stage_rows<bf16, kSlice, kRows, kBf16Threads>(Qs, q, base, rs, q0, L,
                                                kSlice);
  load(Kr, k, 0);  // Q travels in the first group
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[kSlice / 16][4];  // this warp's Q rows as A fragments
#pragma unroll
  for (int c = 0; c < kSlice / 16; ++c)
    ldsm_x4(qa[c], a_frag(Qs, S, qr, 16 * c));

  // acc[f]: rows qr + g (+ 8) x features 8 f + 2 t (+ 1) of the slice; m:
  // the running max of S * s * log2(e) of those rows; lsum: this thread's
  // part of their sums; pa: the tile before's P, rounded to bf16, as the A
  // operand of P V
  float acc[NF][4], m[2], lsum[2];
  uint32_t pa[NS][2];
  m[0] = m[1] = -INFINITY;
  lsum[0] = lsum[1] = 0.f;
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  // O += P V over the 16-key steps [KQ0, KQ1) of a tile, V's fragments by
  // ldmatrix.trans
  auto pv = [&](const bf16* Vs, auto kq0, auto kq1) {
#pragma unroll
    for (int kq = decltype(kq0)::value; kq < decltype(kq1)::value; ++kq) {
      const uint32_t a[4] = {pa[2 * kq][0], pa[2 * kq][1], pa[2 * kq + 1][0],
                             pa[2 * kq + 1][1]};
#pragma unroll
      for (int f = 0; f < NF; f += 2) {
        uint32_t bb[4];
        ldsm_x4_t(bb, bt_frag(Vs, S, kq * 16, f * 8));
        mma16816(acc[f], a, bb[0], bb[1]);
        mma16816(acc[f + 1], a, bb[2], bb[3]);
      }
    }
  };
  using Zero = std::integral_constant<int, 0>;
  using Split = std::integral_constant<int, kPvInA / 16>;
  using End = std::integral_constant<int, BN / 16>;

  const int tiles = (kv_end + BN - 1) / BN;
  for (int tt = 0; tt < tiles; ++tt) {
    const int k0 = tt * BN;
    if (tt > 0) {
      cp_async_wait_all();
      __syncthreads();  // K(t), V(t - 1) landed; K(t - 1), V(t - 2) consumed
    }
    if (k0 + BN < kv_end) load(Kr + ((tt + 1) & 1) * BN * S, k, k0 + BN);
    load(Vr + (tt & 1) * BN * S, v, k0);
    cp_async_commit();
    const bf16* Ks = Kr + (tt & 1) * BN * S;
    const bf16* Vp = Vr + ((tt + 1) & 1) * BN * S;  // V(t - 1)

    // s[nt][e]: row q0 + qr + g + 8 (e / 2), key k0 + 8 nt + 2 t + e % 2;
    // this slice's part
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int c = 0; c < kSlice / 16; ++c) {
#pragma unroll
      for (int nt = 0; nt < NS; nt += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, b_frag(Ks, S, nt * 8, 16 * c));
        mma16816(s[nt], qa[c], bb[0], bb[1]);
        mma16816(s[nt + 1], qa[c], bb[2], bb[3]);
      }
    }

    // the whole S: partials out, reduce-scatter, sums back; P V of the
    // tile before runs while each barrier completes
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(
            &Xs[(qr + g + 8 * half) * kXBf16 + 8 * nt + 2 * t]) =
            make_float2(s[nt][2 * half], s[nt][2 * half + 1]);
    cluster_arrive();
    if (tt > 0) pv(Vp, Zero(), Split());
    cluster_wait();  // every CTA's partial landed
    sum_own_lines<kBf16Threads, kTile, kXBf16, kTile>(cluster, Xs, Ys,
                                                    rank, n);
    cluster_arrive();
    if (tt > 0) pv(Vp, Split(), End());
    cluster_wait();  // every owner's sums landed
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* row =
          summed<kTile, kXBf16>(cluster, Ys, qr + g + 8 * half, 0, n);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        const float2 x = *reinterpret_cast<const float2*>(row + 8 * nt + 2 * t);
        s[nt][2 * half] = x.x;
        s[nt][2 * half + 1] = x.y;
      }
    }

    const bool inner = k0 + BN <= L && (!kCausal || k0 + BN - 1 <= q0);
    if (!inner) {
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + qr + g + 8 * (e >> 1);
          const int col = k0 + 8 * nt + 2 * t + (e & 1);
          if (col >= L || (kCausal && col > row)) s[nt][e] = -INFINITY;
        }
    }
    // the accumulator holds P V up to tile t - 1: rescaled to tile t's max
    float m2[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], __fmul_rn(mx, scale2));
      m2[half] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha =
          m[half] == m2[half] ? 1.f : fast_exp2(m[half] - m2[half]);
      m[half] = m_new;
      lsum[half] *= alpha;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        acc[f][2 * half] *= alpha;
        acc[f][2 * half + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = fast_exp2(fmaf(s[nt][e], scale2, -m2[e >> 1]));
        lsum[e >> 1] += s[nt][e];
      }
      pa[nt][0] = pack_bf16(s[nt][0], s[nt][1]);
      pa[nt][1] = pack_bf16(s[nt][2], s[nt][3]);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // V of the last tile landed
  pv(Vr + ((tiles + 1) & 1) * BN * S, Zero(), End());
  cluster.sync();  // no CTA leaves while another reads its Y

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = lsum[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + qr + g + 8 * half;
    if (lse && rank == 0 && t == 0 && row < L)
      lse[((long long)b * H + h) * L + row] = m[half] * kLn2 + logf(lt);
    const float den = fmaxf(lt, 1e-20f);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      acc[f][2 * half] /= den;
      acc[f][2 * half + 1] /= den;
    }
  }
  write_bf16<kSlice>(o, acc, base, rs, q0 + qr, L, kSlice);
}

// ---------------------------------------------------------------------------
// launch

static_assert(kF32Floats * 4 <= 232448 && kBf16Bytes <= 232448,
              "a CTA's shared memory");

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, L, H, D, dtype, causal;
  float scale;
  cudaStream_t stream;
};

void* kernel_of(int dtype, int causal) {
  if (dtype == 0)
    return causal ? (void*)wide_fwd_f32<true> : (void*)wide_fwd_f32<false>;
  return causal ? (void*)wide_fwd_bf16<true> : (void*)wide_fwd_bf16<false>;
}

// the launch: a cluster of D / 128 CTAs along x; grid (n * H, B, query
// tiles), the last query tile first (z = 0)
cudaLaunchConfig_t plan(const Args& a, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  const int n = a.D / kSlice;
  cfg.gridDim = dim3(n * a.H, a.B, (a.L + kRows - 1) / kRows);
  cfg.blockDim = dim3(a.dtype == 0 ? kF32Threads : kBf16Threads);
  cfg.dynamicSmemBytes =
      a.dtype == 0 ? kF32Floats * sizeof(float) : (size_t)kBf16Bytes;
  cfg.stream = a.stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool takes(int B, int L, int H, int D, int dtype) {
  return B > 0 && L > 0 && H > 0 && B <= 65535 && H <= 65535 &&
         D >= kMinCluster * kSlice && D <= kMaxCluster * kSlice &&
         D % kSlice == 0 && (L + kRows - 1) / kRows <= kMaxTiles &&
         (dtype == 0 || dtype == 1);
}

template <typename T, typename K>
cudaError_t launch_typed(const Args& a, K kernel) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan(a, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q),
                            static_cast<const T*>(a.k),
                            static_cast<const T*>(a.v), static_cast<T*>(a.o),
                            a.lse, a.L, a.H, a.D, a.scale);
}

cudaError_t launch(const Args& a) {
  cudaError_t err;
  if (a.dtype == 0)
    err = a.causal ? launch_typed<float>(a, wide_fwd_f32<true>)
                   : launch_typed<float>(a, wide_fwd_f32<false>);
  else
    err = a.causal ? launch_typed<bf16>(a, wide_fwd_bf16<true>)
                   : launch_typed<bf16>(a, wide_fwd_bf16<false>);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// Raise the dynamic shared-memory ceiling of the four kernels (once).
int pio_flash_attn_wide_init() {
  for (int dtype = 0; dtype < 2; ++dtype)
    for (int causal = 0; causal < 2; ++causal) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel_of(dtype, causal),
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          dtype == 0 ? kF32Floats * (int)sizeof(float) : kBf16Bytes);
      if (err != cudaSuccess) return (int)err;
    }
  return (int)cudaSuccess;
}

// q, k, v, o: [B, L, H, D] contiguous, 16-byte aligned device buffers of one
// type (dtype 0 = f32, 1 = bf16); D a multiple of 128 from 384 to 1024; L >=
// 1 and at most 65535 query tiles of 64, B and H <= 65535 (the wrapper
// checks). lse: null, or a [B, H, L] f32 device buffer that receives each
// row's logsumexp. Launches on `stream`; returns the cudaError of the
// launch.
int pio_flash_attn_wide_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int L, int H, int D,
                            int dtype, int causal, float scale,
                            void* stream) {
  if (!takes(B, L, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, L, H, D, dtype,
               causal, scale, static_cast<cudaStream_t>(stream)};
  return (int)launch(a);
}

// The launch plan of a forward call, as ops/kernels.py::wide_fwd_plan
// computes it: out = {cluster size, grid x, y, z, threads a CTA, dynamic
// shared-memory bytes a CTA, clusters the card holds at once
// (cudaOccupancyMaxActiveClusters)}. Returns the cudaError of the query.
int pio_flash_attn_wide_fwd_plan(int B, int L, int H, int D, int dtype,
                                 int causal, int* out) {
  if (!takes(B, L, H, D, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, B, L, H, D,
               dtype, causal, 1.f, nullptr};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = plan(a, &attr);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, kernel_of(dtype, causal), &cfg);
  const int vals[7] = {(int)attr.val.clusterDim.x, (int)cfg.gridDim.x,
                       (int)cfg.gridDim.y, (int)cfg.gridDim.z,
                       (int)cfg.blockDim.x, (int)cfg.dynamicSmemBytes,
                       clusters};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return (int)err;
}

}  // extern "C"
