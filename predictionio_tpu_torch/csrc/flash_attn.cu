// Exact flash-attention forward for Hopper (sm_90a): O = softmax(Q K^T * s) V.
//
// Replaces the Pallas TPU kernel
// jax/experimental/pallas/ops/tpu/flash_attention.py::_flash_attention_kernel,
// as reached from predictionio_tpu/parallel/ring_attention.py::flash_attention
// (the seqrec model's attention, predictionio_tpu/models/seq_attention.py).
// Same function as that kernel and as the plain version
// predictionio_tpu_torch/parallel/ring_attention.py::blockwise_attention:
// q, k, v [B, L, H, D] (f32 or bf16, row-major, contiguous), s = 1/sqrt(D),
// optional causal mask (key j visible to query i iff j <= i), no key-padding
// mask, f32 running max / sum / accumulator, output in the input dtype.
// With bf16 inputs the products are exact in f32 and the softmax weights P are
// rounded to bf16 before P V, as the plain version does; the row sum uses the
// unrounded P. With f32 inputs everything stays f32: CUDA-core FMAs in a fixed
// order (feature 0 first, key 0 first), no TF32, no tensor cores.
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
// Design. The TPU kernel walks the kv blocks of a query block in grid order,
// carrying m / l / acc in VMEM scratch across grid steps. Here one CTA owns one
// (batch, head, 64-row query tile) and loops over 64-key K/V tiles itself, so
// nothing crosses CTAs: the Q tile is staged once in shared memory (transposed,
// so the inner product reads 16-byte vectors), each K/V tile is staged in turn,
// the running max, sum and accumulator live in registers, and O is written
// once. 256 threads form a 16 x 16 grid; each owns a 4 x 4 block of the 64 x 64
// score tile (row max and sum are shuffles across the 16 threads of a row
// group) and a 4-row x D/16-column block of the output. Causal tiles wholly
// above the diagonal are never loaded, and the CTAs of the heaviest (last)
// query tiles are scheduled first. P reuses the K tile's shared memory.
// The head dim is padded with zeros to 32, 64 or 128 in shared memory (zeros
// add exactly nothing to the f32 sums); the ragged last tile is masked.
// This first version uses CUDA cores for both types: the bf16 path does not
// reach the tensor cores (mma / wgmma), which is left to a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;           // 16 x 16 threads per CTA
constexpr int kTileM = 64;              // query rows per CTA
constexpr int kTileN = 64;              // keys per K/V tile
constexpr int kStrideT = kTileM + 4;    // transposed tiles: 16-byte rows, fewer conflicts

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
// P as the plain version feeds it to P V: f32 as is, or rounded to bf16
template <typename T>
__device__ __forceinline__ float p_round(float p) {
  if constexpr (std::is_same<T, float>::value) return p;
  else return __bfloat162float(__float2bfloat16_rn(p));
}

template <int DP>
constexpr int smem_floats() {
  // Qt [DP][68], Kt (then Pt) [max(DP, 64)][68], V [64][DP]
  return DP * kStrideT + (DP > kTileN ? DP : kTileN) * kStrideT + kTileN * DP;
}

template <typename T, int DP, bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int L, int H, int D,
          float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                              // Qt[d * kStrideT + i]
  float* Kt = Qt + DP * kStrideT;                // Kt[d * kStrideT + j]
  float* Pt = Kt;                                // Pt[j * kStrideT + i], after S
  float* Vs = Kt + (DP > kTileN ? DP : kTileN) * kStrideT;  // Vs[j * DP + d]
  constexpr int kCols = DP / 16;                 // output columns per thread

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTileM;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long rs = (long long)H * D;         // elements between positions
  const long long base = (long long)b * L * rs + (long long)h * D;

  for (int idx = tid; idx < kTileM * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP, row = q0 + r;
    Qt[d * kStrideT + r] =
        (row < L && d < D) ? to_f32(q[base + row * rs + d]) : 0.f;
  }

  float acc[4][kCols];
  float m[4], lsum[4];                           // lsum: this thread's part
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    lsum[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
  }

  const int kv_end = kCausal ? min(L, q0 + kTileM) : L;
  for (int k0 = 0; k0 < kv_end; k0 += kTileN) {
    __syncthreads();  // the previous tile's P and V are consumed
    for (int idx = tid; idx < kTileN * DP; idx += kThreads) {
      const int r = idx / DP, d = idx % DP, col = k0 + r;
      const bool ok = col < L && d < D;
      Kt[d * kStrideT + r] = ok ? to_f32(k[base + col * rs + d]) : 0.f;
      Vs[r * DP + d] = ok ? to_f32(v[base + col * rs + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * kStrideT + 4 * ty]);
      const float4 kb = *reinterpret_cast<const float4*>(&Kt[d * kStrideT + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = q0 + 4 * ty + a;
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + 4 * tx + c;
        const bool ok = col < L && (!kCausal || col <= row);
        s[a][c] = ok ? s[a][c] * scale : -INFINITY;
        mt = fmaxf(mt, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[a], mt);
      // a row with no visible key yet keeps exp(-inf) = 0 weights
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[a] - m_use);
      m[a] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = expf(s[a][c] - m_use);
        ps += e;
        p[a][c] = p_round<T>(e);
      }
      lsum[a] = lsum[a] * alpha + ps;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();  // every thread is done reading Kt: P takes its place
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Pt[(4 * tx + c) * kStrideT + 4 * ty]) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTileN; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[j * kStrideT + 4 * ty]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[j * DP + tx * kCols + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float lt = lsum[a];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + 4 * ty + a;
    if (row >= L) continue;
    const float den = fmaxf(lt, 1e-20f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx * kCols + c;
      if (d < D) store(&o[base + row * rs + d], acc[a][c] / den);
    }
  }
}

template <typename T, int DP, bool kCausal>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(flash_fwd<T, DP, kCausal>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_floats<DP>() * (int)sizeof(float));
}

template <typename T>
cudaError_t init_type() {
  cudaError_t err;
  if ((err = set_smem<T, 32, false>()) || (err = set_smem<T, 32, true>()) ||
      (err = set_smem<T, 64, false>()) || (err = set_smem<T, 64, true>()) ||
      (err = set_smem<T, 128, false>()) || (err = set_smem<T, 128, true>()))
    return err;
  return cudaSuccess;
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int L, int H, int D, float scale, int causal,
                   cudaStream_t stream) {
  const dim3 grid((L + kTileM - 1) / kTileM, H, B);
  const size_t smem = smem_floats<DP>() * sizeof(float);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (causal)
    flash_fwd<T, DP, true><<<grid, kThreads, smem, stream>>>(qp, kp, vp, op, L,
                                                             H, D, scale);
  else
    flash_fwd<T, DP, false><<<grid, kThreads, smem, stream>>>(qp, kp, vp, op, L,
                                                              H, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_type(const void* q, const void* k, const void* v, void* o,
                        int B, int L, int H, int D, float scale, int causal,
                        cudaStream_t stream) {
  if (D <= 32) return launch<T, 32>(q, k, v, o, B, L, H, D, scale, causal, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, o, B, L, H, D, scale, causal, stream);
  return launch<T, 128>(q, k, v, o, B, L, H, D, scale, causal, stream);
}

}  // namespace

extern "C" {

// Raise the dynamic shared-memory ceiling of every instantiation (once).
int pio_flash_attn_init() {
  cudaError_t err = init_type<float>();
  if (err == cudaSuccess) err = init_type<__nv_bfloat16>();
  return (int)err;
}

// q, k, v, o: [B, L, H, D] contiguous device buffers of one type (dtype 0 =
// f32, 1 = bf16); 8 <= D <= 128 with D % 8 == 0, L >= 1, B and H <= 65535
// (the wrapper checks). Launches on `stream`; returns the cudaError of the
// launch.
int pio_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                       int B, int L, int H, int D, int dtype, int causal,
                       float scale, void* stream_ptr) {
  if (B <= 0 || L <= 0 || H <= 0 || D < 8 || D > 128 || D % 8 || B > 65535 ||
      H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const cudaError_t err =
      dtype == 0
          ? launch_type<float>(q, k, v, o, B, L, H, D, scale, causal, stream)
          : launch_type<__nv_bfloat16>(q, k, v, o, B, L, H, D, scale, causal,
                                       stream);
  return (int)err;
}

}  // extern "C"
