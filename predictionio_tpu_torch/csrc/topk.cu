// Exact inner-product top-k of queries against a catalog, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel predictionio_tpu/ops/retrieval.py::_topk_kernel
// (launched by _raw_call, and fused with the query-row gather in
// predictionio_tpu/ops/pipeline.py::ServingPipeline._exec_fused). Same contract:
// rows at or past n_total score -inf; the result is ordered by score
// descending, then catalog id ascending (lax.top_k's order); a non-finite
// score gets id -1. -0.0 is canonicalised to +0.0 first, because the TPU
// kernel's `mv == m` treats the two as equal and zero-query ties rest on it.
//
// Design. The TPU kernel walks the catalog in order on one core, revisiting
// one output block; on a GPU that would serialise. Here the work splits in two:
//
//   stage 1: one CTA of 8 warps per (query tile of QT = 8, 16 or 32 x
//     256-row catalog chunk). It scores with f32 FMAs on CUDA cores (no TF32,
//     no cuBLAS; each score one fmaf chain from feature 0, so every version
//     gives the same bits), masks id >= n_total to -inf, turns each score into
//     a 64-bit key and writes the chunk's best kc = min(k, 256) keys, sorted
//     descending, to a workspace. Two kernels, one list layout:
//     - topk_select (kc <= 32, every serving shape). Warp w owns QT/8
//       queries and lane l the items l, l+32, .., l+224, so each thread holds
//       a QT/8 x 8 register tile of scores, fed by 16-byte shared loads
//       (the items' rows padded to 36 floats, conflict-free; the queries'
//       broadcast). The chunk's rows and the tile's query rows (through
//       `rows` for the gather variant) stream in 32-feature slabs through a
//       two-stage cp.async ring. The scores never leave registers: a lane
//       sorts its 8 keys of a query with a 19-comparator network, then kc
//       rounds each take the warp's largest head (two `redux.sync` maxima:
//       the high words, then the low words of the heads that carry the
//       largest high word) and the winning lane pops it.
//     - topk_partial (kc > 32). One catalog row per thread against all QT
//       queries, the chunk staged 32 features at a time, then a CTA-wide
//       bitonic sort of each query's 256 keys.
//   stage 2 (topk_merge): one CTA per query row merges the chunk lists
//     pairwise, level by level, each key finding its place in the merged list
//     by a binary search in the partner list; lists stay capped at k. The
//     lists live in shared memory when they fit, else in the workspace.
//
// The key is the order-preserving bits of the f32 score above the bitwise NOT
// of the id, so a larger key means a higher score, then a lower id, and keys
// are unique because ids are.
//
// What bounds it on the card: at the ML-20M serving shape (27,136 x 128 f32
// catalog, 13.9 MB; up to 128 queries) one call reads the catalog once from
// device memory (about 4 us at 3.35 TB/s) and does 2*B*N*D FLOP, 0.89 GFLOP at
// B = 128 (about 13 us at 67 TFLOP/s f32): f32 FMA throughput bounds the large
// batches, memory the small ones. Stage 1 re-reads the catalog once per query
// tile (from L2, where it stays resident). In topk_select every warp reads
// the whole chunk from shared memory, so at QT 32 the shared loads and the
// FMAs take about as long as each other, and at QT 8 the shared loads bound
// the scoring; at QT 32, kc 16 the selection costs about half as many
// instructions as the scoring.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // threads per CTA, both stages
constexpr int kChunk = 256;                  // catalog rows per stage-1 CTA
constexpr int kSlab = 32;                    // features staged per pass
constexpr int kSlabStride = kSlab + 1;       // padded row: conflict-free reads
constexpr int kMergeSmemMax = 192 * 1024;    // stage-2 shared-memory ceiling

__device__ __forceinline__ uint64_t make_key(float score, uint32_t id) {
  uint32_t u = __float_as_uint(score);
  if (u == 0x80000000u) u = 0u;              // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (uint64_t(u) << 32) | uint64_t(~id);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  uint32_t u = uint32_t(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_id(uint64_t key) {
  return int(~uint32_t(key & 0xffffffffull));
}

// Number of keys greater than `key` in the descending list [list, list + n).
__device__ __forceinline__ int count_greater(const uint64_t* list, int n,
                                             uint64_t key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] > key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <int QT>
constexpr int partial_smem_bytes() {
  return QT * kSlab * int(sizeof(float)) +
         (kChunk * kSlabStride * int(sizeof(float)) >
                  QT * kChunk * int(sizeof(uint64_t))
              ? kChunk * kSlabStride * int(sizeof(float))
              : QT * kChunk * int(sizeof(uint64_t)));
}

// Stage 1. grid = (n_chunks, b_pad / QT), block = kThreads.
// q: [q_rows, dim] f32; rows: [b_pad] int32 or null (then query b is q row b);
// items: [n_items, dim] f32; ws: [b_pad, n_chunks, kc] keys, each list sorted
// descending.
template <int QT>
__global__ void __launch_bounds__(kThreads)
topk_partial(const float* __restrict__ q, const int* __restrict__ rows,
             int64_t q_rows, const float* __restrict__ items, int64_t n_items,
             int dim, int64_t n_total, int kc, int n_chunks,
             uint64_t* __restrict__ ws) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                      // [QT][kSlab]
  unsigned char* region = smem + QT * kSlab * sizeof(float);
  float* its = reinterpret_cast<float*>(region);                   // [kChunk][kSlabStride]
  uint64_t* keys = reinterpret_cast<uint64_t*>(region);            // [QT][kChunk], after scoring
  __shared__ int64_t qrow[QT];

  const int t = threadIdx.x;
  const int chunk = blockIdx.x;
  const int b0 = blockIdx.y * QT;
  const int64_t item0 = int64_t(chunk) * kChunk;

  if (t < QT) {
    int64_t r = b0 + t;
    if (rows != nullptr) {
      r = rows[b0 + t];
      if (r < 0 || r >= q_rows) r = -1;     // scores as a zero query
    }
    qrow[t] = r;
  }
  float acc[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0.0f;
  __syncthreads();

  for (int d0 = 0; d0 < dim; d0 += kSlab) {
    for (int e = t; e < QT * kSlab; e += kThreads) {
      const int64_t r = qrow[e / kSlab];
      qs[e] = r >= 0 ? q[r * dim + d0 + e % kSlab] : 0.0f;
    }
    for (int e = t; e < kChunk * (kSlab / 4); e += kThreads) {
      const int row = e / (kSlab / 4);
      const int c = (e % (kSlab / 4)) * 4;
      const int64_t gi = item0 + row;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gi < n_items)
        v = *reinterpret_cast<const float4*>(items + gi * dim + d0 + c);
      float* dst = its + row * kSlabStride + c;
      dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
    }
    __syncthreads();
    const float* mine = its + t * kSlabStride;
#pragma unroll 2
    for (int dd = 0; dd < kSlab; dd += 4) {
      const float x0 = mine[dd], x1 = mine[dd + 1];
      const float x2 = mine[dd + 2], x3 = mine[dd + 3];
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + i * kSlab + dd);
        float a = acc[i];
        a = fmaf(qv.x, x0, a);
        a = fmaf(qv.y, x1, a);
        a = fmaf(qv.z, x2, a);
        a = fmaf(qv.w, x3, a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  const int64_t item = item0 + t;
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const float s = item < n_total ? acc[i] : -__int_as_float(0x7f800000);
    keys[i * kChunk + t] = make_key(s, uint32_t(item));
  }
  __syncthreads();

  // Bitonic sort of each query's kChunk keys, descending.
  for (int size = 2; size <= kChunk; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = t; p < QT * (kChunk / 2); p += kThreads) {
        uint64_t* row = keys + (p / (kChunk / 2)) * kChunk;
        const int l = p % (kChunk / 2);
        const int i = 2 * stride * (l / stride) + (l % stride);
        const int j = i + stride;
        const uint64_t a = row[i], b = row[j];
        const bool descending = (i & size) == 0;
        if (descending ? (a < b) : (a > b)) { row[i] = b; row[j] = a; }
      }
      __syncthreads();
    }
  }

  for (int e = t; e < QT * kc; e += kThreads) {
    const int i = e / kc, p = e % kc;
    ws[(int64_t(b0 + i) * n_chunks + chunk) * kc + p] = keys[i * kChunk + p];
  }
}

// Stage 1 for kc <= kSelMax: the same lists as topk_partial, from register
// tiles and a warp selection instead of the CTA-wide bitonic sort.

constexpr int kSelMax = 32;                  // largest kc the selection takes
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = kChunk / 32;        // a lane's keys of one query
constexpr int kRowStride = kSlab + 4;        // 16-byte rows, LDS.128 conflict-free

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One ring stage: the chunk's kChunk item rows, then the QT query rows, each
// a kSlab-feature slice padded to kRowStride floats.
template <int QT>
__host__ __device__ constexpr int select_stage_floats() {
  return (kChunk + QT) * kRowStride;
}

template <int QT>
__host__ __device__ constexpr int select_smem_bytes() {
  return 2 * select_stage_floats<QT>() * int(sizeof(float));
}

__device__ __forceinline__ void order_desc(uint64_t& a, uint64_t& b) {
  const uint64_t hi = a > b ? a : b, lo = a > b ? b : a;
  a = hi;
  b = lo;
}

// Batcher's 19-comparator network: k[0..7] sorted descending.
__device__ __forceinline__ void sort8_desc(uint64_t (&k)[kPerLane]) {
  order_desc(k[0], k[1]); order_desc(k[2], k[3]);
  order_desc(k[4], k[5]); order_desc(k[6], k[7]);
  order_desc(k[0], k[2]); order_desc(k[1], k[3]);
  order_desc(k[4], k[6]); order_desc(k[5], k[7]);
  order_desc(k[1], k[2]); order_desc(k[5], k[6]);
  order_desc(k[0], k[4]); order_desc(k[1], k[5]);
  order_desc(k[2], k[6]); order_desc(k[3], k[7]);
  order_desc(k[2], k[4]); order_desc(k[3], k[5]);
  order_desc(k[1], k[2]); order_desc(k[3], k[4]); order_desc(k[5], k[6]);
}

// Stage 1, kc <= kSelMax. grid = (n_chunks, b_pad / QT), block = kThreads;
// the arguments and the lists written to ws are topk_partial's. Warp w owns
// queries w*RQ .. w*RQ+RQ-1 of the tile, and lane l the chunk's items
// l, l+32, .., l+224: each thread scores an RQ x 8 block, features streamed
// through a two-stage cp.async ring, each score one fmaf chain from feature
// 0 (topk_partial's order, so the same bits). A lane sorts its 8 keys of a
// query in registers; then kc rounds each take the warp's largest head,
// lane `round` keeps it and the winning lane pops it.
template <int QT>
__global__ void __launch_bounds__(kThreads, 2)
topk_select(const float* __restrict__ q, const int* __restrict__ rows,
            int64_t q_rows, const float* __restrict__ items, int64_t n_items,
            int dim, int64_t n_total, int kc, int n_chunks,
            uint64_t* __restrict__ ws) {
  constexpr int RQ = QT / kWarps;
  constexpr int kStage = select_stage_floats<QT>();
  constexpr int kCopies = (kChunk + QT) * (kSlab / 4);  // 16-byte copies a stage
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  __shared__ int64_t qrow[QT];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunk = blockIdx.x;
  const int b0 = blockIdx.y * QT;
  const int64_t item0 = int64_t(chunk) * kChunk;

  if (t < QT) {
    int64_t r = b0 + t;
    if (rows != nullptr) {
      r = rows[b0 + t];
      if (r < 0 || r >= q_rows) r = -1;     // scores as a zero query
    }
    qrow[t] = r;
  }
  __syncthreads();

  auto stage = [&](int slab) {
    float* buf = ring + (slab & 1) * kStage;
    const int d0 = slab * kSlab;
    for (int e = t; e < kCopies; e += kThreads) {
      const int row = e / (kSlab / 4), c = (e % (kSlab / 4)) * 4;
      const float* src = items;
      bool ok;
      if (row < kChunk) {
        const int64_t gi = item0 + row;
        ok = gi < n_items;
        if (ok) src = items + gi * dim + d0 + c;
      } else {
        const int64_t r = qrow[row - kChunk];
        ok = r >= 0;
        if (ok) src = q + r * dim + d0 + c;
      }
      cp_async16(buf + row * kRowStride + c, src, ok);
    }
    cp_async_commit();
  };

  float acc[RQ][kPerLane];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[r][j] = 0.0f;

  const int n_slabs = dim / kSlab;
  stage(0);
  for (int slab = 0; slab < n_slabs; ++slab) {
    if (slab + 1 < n_slabs) {
      stage(slab + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = ring + (slab & 1) * kStage;
    const float* qs = buf + (kChunk + warp * RQ) * kRowStride;
    const float* xs = buf + lane * kRowStride;
#pragma unroll
    for (int dd = 0; dd < kSlab; dd += 4) {
      float4 qv[RQ], xv[kPerLane];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qs + r * kRowStride + dd);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        xv[j] = *reinterpret_cast<const float4*>(xs + j * 32 * kRowStride + dd);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          float a = acc[r][j];
          a = fmaf(qv[r].x, xv[j].x, a);
          a = fmaf(qv[r].y, xv[j].y, a);
          a = fmaf(qv[r].z, xv[j].z, a);
          a = fmaf(qv[r].w, xv[j].w, a);
          acc[r][j] = a;
        }
    }
    __syncthreads();
  }

  uint64_t key[RQ][kPerLane];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int64_t item = item0 + lane + 32 * j;
      const float s = item < n_total ? acc[r][j] : -__int_as_float(0x7f800000);
      key[r][j] = make_key(s, uint32_t(item));
    }
    sort8_desc(key[r]);
  }

  // Every real key is > 0 (its low word is ~id >= 1), so 0 marks a lane
  // that has given up all its keys.
  uint64_t out[RQ] = {};
  for (int round = 0; round < kc; ++round) {
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      // the warp's largest head: the largest high word, then the largest
      // low word among the heads that carry it
      const uint32_t khi = uint32_t(key[r][0] >> 32);
      const uint32_t hi = __reduce_max_sync(0xffffffffu, khi);
      const uint32_t lo = __reduce_max_sync(
          0xffffffffu, khi == hi ? uint32_t(key[r][0]) : 0u);
      const uint64_t m = (uint64_t(hi) << 32) | lo;
      if (lane == round) out[r] = m;
      const bool win = key[r][0] == m;
#pragma unroll
      for (int j = 0; j < kPerLane - 1; ++j)
        key[r][j] = win ? key[r][j + 1] : key[r][j];
      key[r][kPerLane - 1] = win ? 0ull : key[r][kPerLane - 1];
    }
  }
  if (lane < kc) {
#pragma unroll
    for (int r = 0; r < RQ; ++r)
      ws[(int64_t(b0 + warp * RQ + r) * n_chunks + chunk) * kc + lane] = out[r];
  }
}

// Length of list `li` at a merge level where each list covers `span` chunks.
__device__ __forceinline__ int list_len(int li, int span, int n_chunks, int kc,
                                        int k_pad) {
  const int chunks = min(span, n_chunks - li * span);
  return int(min(int64_t(chunks) * kc, int64_t(k_pad)));
}

// Stage 2. grid = (b_pad), block = kThreads. Row b's lists start at
// src + b * row_len (row_len = n_chunks * kc); `spare` has the same layout and
// is the ping-pong partner when the lists do not fit in shared memory.
template <bool kInSmem>
__global__ void __launch_bounds__(kThreads)
topk_merge(uint64_t* __restrict__ src_all, uint64_t* __restrict__ spare_all,
           int n_chunks, int kc, int k_pad, float* __restrict__ packed,
           float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int64_t row_len = int64_t(n_chunks) * kc;
  uint64_t* src = src_all + b * row_len;
  uint64_t* dst = spare_all + b * row_len;
  if (kInSmem) {
    uint64_t* s = reinterpret_cast<uint64_t*>(smem);
    for (int64_t e = t; e < row_len; e += kThreads) s[e] = src[e];
    src = s;
    dst = s + row_len;
    __syncthreads();
  }

  int n_lists = n_chunks, stride = kc, span = 1;
  while (n_lists > 1) {
    const int out_stride = min(2 * stride, k_pad);
    const int64_t work = int64_t(n_lists) * stride;
    for (int64_t e = t; e < work; e += kThreads) {
      const int li = int(e / stride);
      const int p = int(e % stride);
      if (p >= list_len(li, span, n_chunks, kc, k_pad)) continue;
      const uint64_t key = src[int64_t(li) * stride + p];
      int pos = p;
      const int other = li ^ 1;
      if (other < n_lists)
        pos += count_greater(src + int64_t(other) * stride,
                             list_len(other, span, n_chunks, kc, k_pad), key);
      if (pos < out_stride) dst[int64_t(li >> 1) * out_stride + pos] = key;
    }
    __syncthreads();
    uint64_t* tmp = src; src = dst; dst = tmp;
    n_lists = (n_lists + 1) >> 1;
    stride = out_stride;
    span <<= 1;
  }

  for (int r = t; r < k_pad; r += kThreads) {
    const uint64_t key = src[r];
    const float v = key_score(key);
    const bool finite =
        (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
    const int id = finite ? key_id(key) : -1;
    if (packed != nullptr) {
      packed[int64_t(b) * 2 * k_pad + r] = v;
      packed[int64_t(b) * 2 * k_pad + k_pad + r] = float(id);
    } else {
      vals[int64_t(b) * k_pad + r] = v;
      ids[int64_t(b) * k_pad + r] = id;
    }
  }
}

template <int QT>
cudaError_t launch_partial(const float* q, const int* rows, int64_t q_rows,
                           int b_pad, const float* items, int64_t n_items,
                           int dim, int64_t n_total, int kc, int n_chunks,
                           uint64_t* ws, cudaStream_t stream) {
  dim3 grid(n_chunks, b_pad / QT);
  if (kc <= kSelMax)
    topk_select<QT><<<grid, kThreads, select_smem_bytes<QT>(), stream>>>(
        q, rows, q_rows, items, n_items, dim, n_total, kc, n_chunks, ws);
  else
    topk_partial<QT><<<grid, kThreads, partial_smem_bytes<QT>(), stream>>>(
        q, rows, q_rows, items, n_items, dim, n_total, kc, n_chunks, ws);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Workspace size in 64-bit keys for one call: two [b_pad, n_chunks, kc]
// buffers (stage-1 lists and the merge's ping-pong partner).
long long pio_topk_workspace(int b_pad, long long n_items, int k_pad) {
  const long long n_chunks = (n_items + kChunk - 1) / kChunk;
  const long long kc = k_pad < kChunk ? k_pad : kChunk;
  return 2LL * b_pad * n_chunks * kc;
}

// Raises the dynamic shared-memory ceilings; call once after loading.
int pio_topk_init() {
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial<32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      partial_smem_bytes<32>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_select<8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             select_smem_bytes<8>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_select<16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             select_smem_bytes<16>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_select<32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             select_smem_bytes<32>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_merge<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMergeSmemMax);
  return int(err);
}

// One top-k call on `stream`. rows == null: query b is q row b (q has b_pad
// rows). rows != null: query b is q row rows[b]; an out-of-range row scores as
// a zero query. Writes packed [b_pad, 2 k_pad] f32 (scores, then ids as f32)
// when `packed` is not null, else vals [b_pad, k_pad] f32 and ids
// [b_pad, k_pad] int32. Returns a cudaError_t.
int pio_topk(const float* q, const int* rows, long long q_rows, int b_pad,
             const float* items, long long n_items, int dim, long long n_total,
             int k_pad, unsigned long long* ws, float* packed, float* vals,
             int* ids, void* stream_ptr) {
  if (b_pad <= 0 || b_pad % 8 != 0 || dim <= 0 || dim % kSlab != 0 ||
      n_items <= 0 || n_items >= (1LL << 32) || k_pad <= 0 ||
      k_pad > n_items || n_total > n_items)
    return int(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t n_chunks64 = (n_items + kChunk - 1) / kChunk;
  if (n_chunks64 > 0x7fffffff) return int(cudaErrorInvalidValue);
  const int n_chunks = int(n_chunks64);
  const int kc = k_pad < kChunk ? k_pad : kChunk;
  uint64_t* lists = reinterpret_cast<uint64_t*>(ws);
  uint64_t* spare = lists + int64_t(b_pad) * n_chunks * kc;

  cudaError_t err;
  if (b_pad % 32 == 0)
    err = launch_partial<32>(q, rows, q_rows, b_pad, items, n_items, dim,
                             n_total, kc, n_chunks, lists, stream);
  else if (b_pad % 16 == 0)
    err = launch_partial<16>(q, rows, q_rows, b_pad, items, n_items, dim,
                             n_total, kc, n_chunks, lists, stream);
  else
    err = launch_partial<8>(q, rows, q_rows, b_pad, items, n_items, dim,
                            n_total, kc, n_chunks, lists, stream);
  if (err != cudaSuccess) return int(err);

  const int64_t merge_smem = 2 * int64_t(n_chunks) * kc * sizeof(uint64_t);
  if (merge_smem <= kMergeSmemMax)
    topk_merge<true><<<b_pad, kThreads, size_t(merge_smem), stream>>>(
        lists, spare, n_chunks, kc, k_pad, packed, vals, ids);
  else
    topk_merge<false><<<b_pad, kThreads, 0, stream>>>(
        lists, spare, n_chunks, kc, k_pad, packed, vals, ids);
  return int(cudaGetLastError());
}

}  // extern "C"
