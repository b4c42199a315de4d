// Exact attention backward for head dims above 256 on Hopper (sm_90a): dK/dV
// and dQ of O = softmax(Q K^T * s) V, for every head dim from 257 to 1024.
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
// plain version rounds them; dS uses the unrounded P.
//
// D here is a multiple of 128 from 384 to 1024 (the caller zero-pads the
// head dim up to one, which is exact, as for the narrow kernels).
//
// What bounds it on the card: operations. A call does 8*D FLOP per visible
// (query, key) pair for dK/dV and 6*D for dQ, against a few bytes a pair;
// the bound is that count at the f32 peak for f32 and at the bf16
// tensor-core peak for bf16. These first versions are simple and do not
// come near it: every product is a CUDA-core FFMA (no tensor cores, in bf16
// too), and the dot products end in warp shuffles.
//
// Design: one warp per output row. A warp owns one query row (dQ) or one
// key row (dK/dV); its 32 lanes stride over the features, lane l holding
// features l, l + 32, ..., so a lane keeps D/32 floats of each row vector
// in registers (32 at D 1024): the query row, dO row and dQ for dQ; the key
// row, value row, dK and dV for dK/dV. The 8 warps of a CTA take 8
// neighbouring rows of one (batch, head) and share the other side's rows,
// which they stage in shared memory 16 at a time as f32 ([16][D] for each
// of two tensors: 128 KB at D 1024, dynamic shared memory above 48 KB).
// Consecutive lanes read consecutive features, so the staged rows are read
// without bank conflicts. A dot product is D/32 FFMAs a lane and a
// butterfly of five xor shuffles, after which every lane holds the same
// sum. Causal rows stop at the diagonal: dQ stages keys up to the CTA's
// last query row, dK/dV stages queries from the CTA's first key row on, and
// a warp skips the pairs its row does not see.
//
// Determinism: no atomics; every sum runs in one fixed order (features by
// lane, then the fixed butterfly; keys or queries in increasing position),
// so two runs give the same bits.
//
// P is rebuilt from the forward's logsumexp (natural-log units, as every
// forward kernel writes it) as P = exp2(S * s * log2(e) - lse * log2(e)),
// with s * log2(e) folded into the query (dQ) or key (dK/dV) row once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;             // output rows a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;             // staged rows of the other side a tile

__device__ __forceinline__ float load(float x) { return x; }
__device__ __forceinline__ float load(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T store(float x);
template <>
__device__ __forceinline__ float store<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 store<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x as the product's operand: rounded to bf16 for bf16 inputs (as the plain
// version rounds P and dS), unchanged for f32
template <typename T>
__device__ __forceinline__ float operand(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float operand<float>(float x) {
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a lane's share of row . smem row: D/32 FFMAs, feature lane first
template <int NPL>
__device__ __forceinline__ float dot(const float (&r)[NPL], const float* s,
                                     int lane) {
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < NPL; ++j) d = fmaf(r[j], s[j * 32 + lane], d);
  return d;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* di;
  void* out0;  // dk (dK/dV), dq (dQ)
  void* out1;  // dv (dK/dV)
  int B, L, H, D, causal;
  float scale;
  cudaStream_t stream;
};

// element offset of row `pos` of (b, h) in a [B, L, H, D] tensor
__device__ __forceinline__ size_t row_off(int b, int pos, int h, int L,
                                          int H, int D) {
  return (((size_t)b * L + pos) * H + h) * (size_t)D;
}

// stage rows [p0, p0 + kTile) of (b, h) of two tensors as f32, zeros past L
template <typename T, int D>
__device__ __forceinline__ void stage(float* xs, float* ys, const T* x,
                                      const T* y, int b, int h, int p0,
                                      int L, int H) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e - r * D, pos = p0 + r;
    float xv = 0.f, yv = 0.f;
    if (pos < L) {
      const size_t off = row_off(b, pos, h, L, H, D) + c;
      xv = load(x[off]);
      yv = load(y[off]);
    }
    xs[e] = xv;
    ys[e] = yv;
  }
}

// ---------------------------------------------------------------------------
// dQ: one warp per query row, K/V tiles staged; P from the logsumexp

template <typename T, int NPL>
__global__ void __launch_bounds__(kThreads)
    wide_bwd_dq(const Args a) {
  constexpr int D = NPL * 32;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = smem + kTile * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L = a.L, H = a.H;
  const int row = blockIdx.x * kWarps + warp;
  const bool active = row < L;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float c = a.scale * kLog2e;

  float qr[NPL], dor[NPL], dq[NPL];
  const size_t roff = active ? row_off(b, row, h, L, H, D) : 0;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    qr[j] = active ? load(q[roff + j * 32 + lane]) * c : 0.f;
    dor[j] = active ? load(dout[roff + j * 32 + lane]) : 0.f;
    dq[j] = 0.f;
  }
  const size_t rrow = ((size_t)b * H + h) * L + row;
  const float lse2 = active ? a.lse_in[rrow] * kLog2e : 0.f;
  const float di = active ? a.di[rrow] : 0.f;
  const int last = min(L - 1, (int)blockIdx.x * kWarps + kWarps - 1);
  const int kend = a.causal ? last + 1 : L;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();
    stage<T, D>(ks, vs, k, v, b, h, k0, L, H);
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      const int kpos = k0 + r;
      const float* kr = ks + r * D;
      const float s = warp_sum(dot<NPL>(qr, kr, lane));
      const float dp = warp_sum(dot<NPL>(dor, vs + r * D, lane));
      if (kpos >= L || (a.causal && kpos > row)) continue;
      const float p = exp2f(s - lse2);
      const float ds = operand<T>((dp - di) * p * a.scale);
#pragma unroll
      for (int j = 0; j < NPL; ++j) dq[j] = fmaf(ds, kr[j * 32 + lane], dq[j]);
    }
  }
  if (!active) return;
  T* out = static_cast<T*>(a.out0);
#pragma unroll
  for (int j = 0; j < NPL; ++j) out[roff + j * 32 + lane] = store<T>(dq[j]);
}

// ---------------------------------------------------------------------------
// dK/dV: one warp per key row, Q/dO tiles staged with their lse and di

template <typename T, int NPL>
__global__ void __launch_bounds__(kThreads)
    wide_bwd_dkv(const Args a) {
  constexpr int D = NPL * 32;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = smem + kTile * D;
  float* lses = smem + 2 * kTile * D;  // [kTile], log2 units
  float* dis = lses + kTile;           // [kTile]
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int L = a.L, H = a.H;
  const int col = blockIdx.x * kWarps + warp;
  const bool active = col < L;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float c = a.scale * kLog2e;

  float kr[NPL], vr[NPL], dk[NPL], dv[NPL];
  const size_t coff = active ? row_off(b, col, h, L, H, D) : 0;
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    kr[j] = active ? load(k[coff + j * 32 + lane]) * c : 0.f;
    vr[j] = active ? load(v[coff + j * 32 + lane]) : 0.f;
    dk[j] = 0.f;
    dv[j] = 0.f;
  }
  const int first = blockIdx.x * kWarps;  // the CTA's first key row
  const int qstart = a.causal ? first / kTile * kTile : 0;
  const size_t rows = ((size_t)b * H + h) * L;
  for (int q0 = qstart; q0 < L; q0 += kTile) {
    __syncthreads();
    stage<T, D>(qs, dos, q, dout, b, h, q0, L, H);
    if (threadIdx.x < kTile) {
      const int pos = q0 + threadIdx.x;
      lses[threadIdx.x] = pos < L ? a.lse_in[rows + pos] * kLog2e : 0.f;
      dis[threadIdx.x] = pos < L ? a.di[rows + pos] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      const int qpos = q0 + r;
      const float* qrow = qs + r * D;
      const float* dorow = dos + r * D;
      const float s = warp_sum(dot<NPL>(kr, qrow, lane));
      const float dp = warp_sum(dot<NPL>(vr, dorow, lane));
      if (qpos >= L || (a.causal && qpos < col)) continue;
      const float p = exp2f(s - lses[r]);
      const float pr = operand<T>(p);
      const float ds = operand<T>((dp - dis[r]) * p * a.scale);
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        dv[j] = fmaf(pr, dorow[j * 32 + lane], dv[j]);
        dk[j] = fmaf(ds, qrow[j * 32 + lane], dk[j]);
      }
    }
  }
  if (!active) return;
  T* dko = static_cast<T*>(a.out0);
  T* dvo = static_cast<T*>(a.out1);
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    dko[coff + j * 32 + lane] = store<T>(dk[j]);
    dvo[coff + j * 32 + lane] = store<T>(dv[j]);
  }
}

// ---------------------------------------------------------------------------
// host side

enum Kind { kDq = 0, kDkv = 1 };

template <int NPL>
constexpr int smem_bytes(int kind) {
  return (2 * kTile * NPL * 32 + (kind == kDkv ? 2 * kTile : 0)) *
         (int)sizeof(float);
}

template <typename T, int NPL>
void* kernel_of(int kind) {
  return kind == kDq ? (void*)wide_bwd_dq<T, NPL>
                     : (void*)wide_bwd_dkv<T, NPL>;
}

template <typename T, int NPL>
cudaError_t set_smem() {
  for (int kind = kDq; kind <= kDkv; ++kind) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_of<T, NPL>(kind), cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<NPL>(kind));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int NPL>
cudaError_t launch_npl(const Args& a, int kind) {
  const dim3 grid((a.L + kWarps - 1) / kWarps, a.H, a.B);
  const int bytes = smem_bytes<NPL>(kind);
  if (kind == kDq)
    wide_bwd_dq<T, NPL><<<grid, kThreads, bytes, a.stream>>>(a);
  else
    wide_bwd_dkv<T, NPL><<<grid, kThreads, bytes, a.stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a, int kind) {
  switch (a.D) {
    case 384: return launch_npl<T, 12>(a, kind);
    case 512: return launch_npl<T, 16>(a, kind);
    case 640: return launch_npl<T, 20>(a, kind);
    case 768: return launch_npl<T, 24>(a, kind);
    case 896: return launch_npl<T, 28>(a, kind);
    case 1024: return launch_npl<T, 32>(a, kind);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t set_smem_t() {
  cudaError_t err;
  if ((err = set_smem<T, 12>()) || (err = set_smem<T, 16>()) ||
      (err = set_smem<T, 20>()) || (err = set_smem<T, 24>()) ||
      (err = set_smem<T, 28>()) || (err = set_smem<T, 32>()))
    return err;
  return cudaSuccess;
}

int launch(const Args& a, int dtype, int kind) {
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.B > 65535 || a.H > 65535 ||
      a.D < 384 || a.D > 1024 || a.D % 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return (int)(dtype == 0 ? launch_t<float>(a, kind)
                           : launch_t<bf16>(a, kind));
}

}  // namespace

extern "C" {

// Raise the dynamic shared-memory ceiling of every instantiation (once).
int pio_flash_attn_wide_bwd_init() {
  cudaError_t err;
  if ((err = set_smem_t<float>()) || (err = set_smem_t<bf16>()))
    return (int)err;
  return (int)cudaSuccess;
}

// dk, dv of the forward for the output gradient do: q, k, v, do, dk, dv
// [B, L, H, D] contiguous device buffers of one type (dtype 0 = f32, 1 =
// bf16); D a multiple of 128 from 384 to 1024; L >= 1, B and H <= 65535
// (the wrapper checks); lse the forward's logsumexp and di = rowsum(do * o),
// [B, H, L] f32. Launches on `stream`; returns the cudaError of the launch.
int pio_flash_attn_wide_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* di, void* dk, void* dv, int B,
                                int L, int H, int D, int dtype, int causal,
                                float scale, void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dk, dv, B, L, H, D, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return launch(a, dtype, kDkv);
}

// dq of the forward, from the same inputs as the dK/dV kernel.
int pio_flash_attn_wide_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* di, void* dq, int B, int L, int H,
                               int D, int dtype, int causal, float scale,
                               void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(di), dq, nullptr, B, L, H, D, causal,
               scale, static_cast<cudaStream_t>(stream)};
  return launch(a, dtype, kDq);
}

}  // extern "C"
