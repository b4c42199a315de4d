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
// are exact in f32, and P and dS are rounded to bf16 before the products
// they feed (dV; dK and dQ), as the stock kernel casts them to the input
// type; dS is formed from the unrounded P. Outputs are in the input type.
// CUDA-core FMAs in a fixed order (feature 0 first, then query or key 0
// first): no atomics, each gradient element is written once by one CTA, so
// the gradients are the same bits from run to run.
//
// What bounds it on the card: operations. dK/dV does 8*D FLOP per visible
// (query, key) pair (S, dP, dV, dK) and dQ 6*D (S, dP, dQ); at the seqrec
// training shape (B 8, L 4096, H 8, D 64, causal) that is 275 and 206 GFLOP
// against 50 MB of f32 in and out: thousands of FLOP per byte, far above the
// H100's ridge points (~20 FLOP/byte for f32 at 67 TFLOP/s, ~295 for bf16
// tensor cores). The bound is the FLOP count at the f32 peak for f32 inputs
// and at the bf16 tensor-core peak for bf16 inputs.
//
// Design. The TPU kernels carry dK/dV (or dQ) in VMEM scratch across a
// sequential grid axis. Here one CTA owns one output tile and walks the other
// axis itself, so nothing crosses CTAs and no atomics are needed, the same
// split into two kernels as the TPU's:
// - dK/dV: one CTA per (head, batch, 64-key tile). K and V are staged once
//   (transposed); the CTA walks the 64-query tiles, under a causal mask from
//   the first tile that reaches the diagonal. For each it stages Q and dO
//   (transposed), lse and di, computes a 4 x 4 block of S and dP per thread,
//   forms P and dS in registers, and passes them through one shared 64 x 64
//   buffer to the dV and dK sums (each thread 4 keys x D/16 features, in
//   registers; 64 floats a thread at D 128). dK and dV are written once. The
//   first key tiles see the most queries under a causal mask, so they are
//   scheduled first (the tile index is the slowest grid axis).
// - dQ: one CTA per (head, batch, 64-query tile). Q, dO, lse and di are
//   staged once; the CTA walks the key tiles up to the diagonal, recomputes
//   S, P, dP and dS and sums dQ += dS K. dS is not written out: the seqrec
//   model passes no attention bias. The last query tiles, the heaviest, go
//   first.
// A thread's feature columns are d = tx + 16 c, so the transposed tiles
// serve both the S / dP products (16-byte loads) and the dK / dV / dQ sums
// (2-way bank conflicts at most). Rows past L, keys past L and padded
// features stage as zeros and are masked before the exponential, so they
// contribute exact zeros and never 0 * inf. The head dim is padded to 32, 64
// or 128 in shared memory: 157 KB at 128, 87.5 KB at 64. CUDA cores for both
// types; tensor cores (mma / wgmma) and TMA are left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;           // 16 x 16 threads per CTA
constexpr int kTile = 64;               // query rows / keys per tile
constexpr int kStrideT = kTile + 4;     // transposed tiles: 16-byte rows
constexpr int kMaxTiles = 65535;        // grid z limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// P or dS as the plain version feeds it to a product: f32 as is, or rounded
// to bf16
template <typename T>
__device__ __forceinline__ float mm_round(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __bfloat162float(__float2bfloat16_rn(x));
}

template <int DP>
constexpr int smem_floats() {
  // four transposed [DP][68] tiles, one [64][68] P / dS buffer, lse and di
  return 4 * DP * kStrideT + kTile * kStrideT + 2 * kTile;
}

// Stage rows [r0, r0 + 64) of x [B, L, H, D] (this CTA's batch and head)
// transposed into xt[d * kStrideT + r], zeros past L and past D.
template <typename T, int DP>
__device__ __forceinline__ void stage_t(float* xt, const T* __restrict__ x,
                                        long long base, long long rs, int r0,
                                        int L, int D) {
  for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP, row = r0 + r;
    xt[d * kStrideT + r] =
        (row < L && d < D) ? to_f32(x[base + row * rs + d]) : 0.f;
  }
}

// a[i][j] += sum_d x[d][4*ra + i] * y[d][4*rb + j] over the transposed tiles
template <int DP>
__device__ __forceinline__ void tile_dot(float (&a)[4][4], const float* xt,
                                         const float* yt, int ra, int rb) {
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    const float4 xa = *reinterpret_cast<const float4*>(&xt[d * kStrideT + 4 * ra]);
    const float4 yb = *reinterpret_cast<const float4*>(&yt[d * kStrideT + 4 * rb]);
    const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
    const float yv[4] = {yb.x, yb.y, yb.z, yb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(xv[i], yv[j], a[i][j]);
  }
}

// acc[a][c] += sum_r buf[r][4*ty + a] * xt[tx + 16 c][r]: the 64-row product
// of a P / dS buffer with a transposed tile, for this thread's 4 rows and
// D/16 feature columns
template <int DP>
__device__ __forceinline__ void buf_dot(float (&acc)[4][DP / 16],
                                        const float* buf, const float* xt,
                                        int tx, int ty) {
  constexpr int kCols = DP / 16;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    const float4 pa = *reinterpret_cast<const float4*>(&buf[r * kStrideT + 4 * ty]);
    const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
    float xv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) xv[c] = xt[(tx + 16 * c) * kStrideT + r];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(pv[a], xv[c], acc[a][c]);
  }
}

// buf[4*tx + c][4*ty + a] = v[a][c]: a thread's 4 x 4 block, transposed
__device__ __forceinline__ void put_block(float* buf, const float (&v)[4][4],
                                          int tx, int ty) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(&buf[(4 * tx + c) * kStrideT + 4 * ty]) =
        make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
}

template <typename T, int DP>
__device__ __forceinline__ void write_rows(T* __restrict__ out,
                                           const float (&acc)[4][DP / 16],
                                           long long base, long long rs,
                                           int r0, int L, int D, int tx,
                                           int ty) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + 4 * ty + a;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(&out[base + row * rs + d], acc[a][c]);
    }
  }
}

template <typename T, int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ di,
              T* __restrict__ dk, T* __restrict__ dv, int L, int H, int D,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                         // Kt[d * kStrideT + j]
  float* Vt = Kt + DP * kStrideT;
  float* Qt = Vt + DP * kStrideT;           // Qt[d * kStrideT + i]
  float* dOt = Qt + DP * kStrideT;
  float* buf = dOt + DP * kStrideT;         // buf[i * kStrideT + j]: P, dS
  float* lse_s = buf + kTile * kStrideT;
  float* di_s = lse_s + kTile;
  constexpr int kCols = DP / 16;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kTile;
  const long long rs = (long long)H * D;    // elements between positions
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * L;  // lse, di rows

  stage_t<T, DP>(Kt, k, base, rs, k0, L, D);
  stage_t<T, DP>(Vt, v, base, rs, k0, L, D);

  float adk[4][kCols], adv[4][kCols];       // keys 4*ty + a, d = tx + 16 c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) adk[a][c] = adv[a][c] = 0.f;

  // under the causal mask no query before k0 sees this key tile
  for (int q0 = kCausal ? k0 : 0; q0 < L; q0 += kTile) {
    __syncthreads();  // the previous tile's Q, dO and buffer are consumed
    stage_t<T, DP>(Qt, q, base, rs, q0, L, D);
    stage_t<T, DP>(dOt, dout, base, rs, q0, L, D);
    if (tid < kTile) {
      const int row = q0 + tid;
      lse_s[tid] = row < L ? lse[rbase + row] : 0.f;
      di_s[tid] = row < L ? di[rbase + row] : 0.f;
    }
    __syncthreads();

    // s[a][c], dp[a][c]: key 4*ty + a, query 4*tx + c
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<DP>(s, Kt, Qt, ty, tx);
    tile_dot<DP>(dp, Vt, dOt, ty, tx);
    float p[4][4], ds[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int col = k0 + 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = 4 * tx + c, row = q0 + r;
        const bool ok = row < L && col < L && (!kCausal || col <= row);
        const float pf = ok ? expf(s[a][c] * scale - lse_s[r]) : 0.f;
        p[a][c] = mm_round<T>(pf);
        ds[a][c] = mm_round<T>((dp[a][c] - di_s[r]) * pf * scale);
      }
    }
    put_block(buf, p, tx, ty);
    __syncthreads();
    buf_dot<DP>(adv, buf, dOt, tx, ty);     // dV += P^T dO
    __syncthreads();
    put_block(buf, ds, tx, ty);
    __syncthreads();
    buf_dot<DP>(adk, buf, Qt, tx, ty);      // dK += dS^T Q
  }
  write_rows<T, DP>(dk, adk, base, rs, k0, L, D, tx, ty);
  write_rows<T, DP>(dv, adv, base, rs, k0, L, D, tx, ty);
}

template <typename T, int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ di,
             T* __restrict__ dq, int L, int H, int D, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                         // Qt[d * kStrideT + i]
  float* dOt = Qt + DP * kStrideT;
  float* Kt = dOt + DP * kStrideT;          // Kt[d * kStrideT + j]
  float* Vt = Kt + DP * kStrideT;
  float* buf = Vt + DP * kStrideT;          // buf[j * kStrideT + i]: dS
  constexpr int kCols = DP / 16;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const long long rs = (long long)H * D;
  const long long base = (long long)b * L * rs + (long long)h * D;
  const long long rbase = ((long long)b * H + h) * L;

  stage_t<T, DP>(Qt, q, base, rs, q0, L, D);
  stage_t<T, DP>(dOt, dout, base, rs, q0, L, D);
  float lse_r[4], di_r[4];                  // rows 4*ty + a
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ty + a;
    lse_r[a] = row < L ? lse[rbase + row] : 0.f;
    di_r[a] = row < L ? di[rbase + row] : 0.f;
  }

  float acc[4][kCols];                      // queries 4*ty + a, d = tx + 16 c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;

  const int kv_end = kCausal ? min(L, q0 + kTile) : L;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous tile's K and dS are consumed
    stage_t<T, DP>(Kt, k, base, rs, k0, L, D);
    stage_t<T, DP>(Vt, v, base, rs, k0, L, D);
    __syncthreads();

    // s[a][c], dp[a][c]: query 4*ty + a, key 4*tx + c
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<DP>(s, Qt, Kt, ty, tx);
    tile_dot<DP>(dp, dOt, Vt, ty, tx);
    float ds[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + 4 * ty + a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + 4 * tx + c;
        const bool ok = row < L && col < L && (!kCausal || col <= row);
        const float pf = ok ? expf(s[a][c] * scale - lse_r[a]) : 0.f;
        ds[a][c] = mm_round<T>((dp[a][c] - di_r[a]) * pf * scale);
      }
    }
    put_block(buf, ds, tx, ty);
    __syncthreads();
    buf_dot<DP>(acc, buf, Kt, tx, ty);      // dQ += dS K
  }
  write_rows<T, DP>(dq, acc, base, rs, q0, L, D, tx, ty);
}

template <typename T, int DP>
cudaError_t set_smem_dp() {
  const int bytes = smem_floats<DP>() * (int)sizeof(float);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(flash_bwd_dkv<T, DP, false>, attr, bytes)) ||
      (err = cudaFuncSetAttribute(flash_bwd_dkv<T, DP, true>, attr, bytes)) ||
      (err = cudaFuncSetAttribute(flash_bwd_dq<T, DP, false>, attr, bytes)) ||
      (err = cudaFuncSetAttribute(flash_bwd_dq<T, DP, true>, attr, bytes)))
    return err;
  return cudaSuccess;
}

template <typename T>
cudaError_t init_type() {
  cudaError_t err;
  if ((err = set_smem_dp<T, 32>()) || (err = set_smem_dp<T, 64>()) ||
      (err = set_smem_dp<T, 128>()))
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

template <typename T, int DP>
cudaError_t launch(const Args& a, bool dkv) {
  const dim3 grid(a.H, a.B, (a.L + kTile - 1) / kTile);
  const size_t smem = smem_floats<DP>() * sizeof(float);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.dout);
  if (dkv) {
    T* dk = static_cast<T*>(a.dk);
    T* dv = static_cast<T*>(a.dv);
    if (a.causal)
      flash_bwd_dkv<T, DP, true><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, o, a.lse, a.di, dk, dv, a.L, a.H, a.D, a.scale);
    else
      flash_bwd_dkv<T, DP, false><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, o, a.lse, a.di, dk, dv, a.L, a.H, a.D, a.scale);
  } else {
    T* dq = static_cast<T*>(a.dq);
    if (a.causal)
      flash_bwd_dq<T, DP, true><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, o, a.lse, a.di, dq, a.L, a.H, a.D, a.scale);
    else
      flash_bwd_dq<T, DP, false><<<grid, kThreads, smem, a.stream>>>(
          q, k, v, o, a.lse, a.di, dq, a.L, a.H, a.D, a.scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(const Args& a, bool dkv) {
  if (a.D <= 32) return launch<T, 32>(a, dkv);
  if (a.D <= 64) return launch<T, 64>(a, dkv);
  return launch<T, 128>(a, dkv);
}

int run(const Args& a, int dtype, bool dkv) {
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.D < 8 || a.D > 128 || a.D % 8 ||
      a.B > 65535 || a.H > 65535 || (a.L + kTile - 1) / kTile > kMaxTiles ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? launch_type<float>(a, dkv)
                          : launch_type<__nv_bfloat16>(a, dkv));
}

}  // namespace

extern "C" {

// Raise the dynamic shared-memory ceiling of every instantiation (once).
int pio_flash_attn_bwd_init() {
  cudaError_t err = init_type<float>();
  if (err == cudaSuccess) err = init_type<__nv_bfloat16>();
  return (int)err;
}

// q, k, v, dout, dk, dv: [B, L, H, D] contiguous device buffers of one type
// (dtype 0 = f32, 1 = bf16); lse, di: [B, H, L] f32. 8 <= D <= 128 with
// D % 8 == 0, L >= 1 and at most 65535 tiles of 64, B and H <= 65535 (the
// wrapper checks). Writes every element of dk and dv. Launches on `stream`;
// returns the cudaError of the launch.
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
