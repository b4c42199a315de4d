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
//     256-row catalog chunk) writes the chunk's best kc = min(k, 256) keys
//     of each query, sorted descending, to a workspace [b_pad, n_chunks, kc].
//     Both kernels score alike (score_tile): warp w owns QT/8 queries and
//     lane l the items l, l+32, .., l+224, so each thread holds a QT/8 x 8
//     register tile of f32 scores (f32 FMAs on CUDA cores, no TF32, no
//     cuBLAS; each score one fmaf chain from feature 0, so every version
//     gives the same bits), fed by 16-byte shared loads (the items' rows
//     padded to 36 floats, conflict-free; the queries' broadcast). The
//     chunk's rows and the tile's query rows (through `rows` for the gather
//     variant) stream in 32-feature slabs through a two-stage cp.async ring.
//     Rows at or past n_total become -inf, each score a 64-bit key, and a
//     lane sorts its 8 keys of a query with a 19-comparator network. The
//     keys never leave registers:
//     - topk_select (kc <= 32, every serving num up to 32): kc rounds each
//       take the warp's largest head (two `redux.sync` maxima: the high
//       words, then the low words of the heads that carry the largest high
//       word) and the winning lane pops it.
//     - topk_sort (kc > 32): the warp finishes a bitonic sort of the 256
//       keys, lane l holding positions 8l .. 8l+7: steps across lanes are
//       `shfl.xor` of the two 32-bit halves, steps within a lane register
//       compare-exchanges; no shared memory and no barrier. The sorted
//       keys turn around through the warp's 2 KB of the idle ring, so the
//       first kc go out in coalesced stores.
//   stage 2: the merge in rounds. A round is one launch of
//     topk_merge_round over (b_pad rows x groups of S lists): CTA (b, g)
//     loads lists gS .. gS+S-1 of row b into shared memory and merges them
//     pairwise, level by level, each key finding its place in the merged
//     list by a binary search in the partner list; lists stay capped at k.
//     It writes one list, and the last round (one group a row) writes the
//     result. The rounds ping-pong between the workspace's two buffers. The
//     host picks S a round (merge_group): the group fits 64 KB of shared
//     memory where it can (three CTAs an SM); the first round has at least
//     one CTA an SM unless the rows alone come within 3/4 of that; the
//     lists left go into one last group once they fit 192 KB. A round
//     whose two lists of k keys pass 192 KB merges pairs straight from the
//     workspace. No atomics and no memset: keys are unique, so any correct
//     merge gives the same bits.
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
// tile (from L2, where it stays resident). Every warp reads the whole chunk
// from shared memory, so at QT 32 the shared loads and the FMAs take about
// as long as each other, and at QT 8 the shared loads bound the scoring. At
// QT 32 the selection costs about half as many instructions as the scoring
// at kc 16; the warp sort (240 shuffles of 32 bits and 60 in-lane
// compare-exchanges a query) about as many. Above k 256 every key of the
// catalog passes through the workspace (written once, read once).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // threads per CTA, both stages
constexpr int kChunk = 256;                  // catalog rows per stage-1 CTA
constexpr int kSlab = 32;                    // features staged per pass
constexpr int kSelMax = 32;                  // largest kc topk_select takes
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = kChunk / 32;        // a lane's keys of one query
constexpr int kRowStride = kSlab + 4;        // 16-byte rows, LDS.128 conflict-free
constexpr int kMergeTarget = 64 * 1024;      // a merge CTA's aimed-for smem
constexpr int kMergeSmemMax = 192 * 1024;    // a merge CTA's smem ceiling
constexpr int kMaxGroups = 65535;            // grid.y of a merge round
// a merge CTA's threads and (by __launch_bounds__) registers let this many
// share an SM; shared memory may let fewer
constexpr int kMergeCtasPerSm = 2048 / kThreads;

int g_sm_count = 132;                        // SMs, read by pio_topk_init

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
__host__ __device__ constexpr int ring_stage_floats() {
  return (kChunk + QT) * kRowStride;
}

template <int QT>
__host__ __device__ constexpr int ring_smem_bytes() {
  return 2 * ring_stage_floats<QT>() * int(sizeof(float));
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

// Stage 1's scoring, for grid = (n_chunks, b_pad / QT), block = kThreads.
// q: [q_rows, dim] f32; rows: [b_pad] int32 or null (then query b is q row
// b); items: [n_items, dim] f32; ring: ring_smem_bytes<QT>() of dynamic
// shared memory, free again on return. Thread (warp w, lane l) of CTA
// (chunk, tile) returns in acc[r][j] the score of query tile*QT + w*RQ + r
// against the chunk's item l + 32j. Features stream through a two-stage
// cp.async ring; each score is one fmaf chain from feature 0.
template <int QT>
__device__ __forceinline__ void score_tile(
    const float* __restrict__ q, const int* __restrict__ rows, int64_t q_rows,
    const float* __restrict__ items, int64_t n_items, int dim, float* ring,
    int64_t* qrow, float (&acc)[QT / kWarps][kPerLane]) {
  constexpr int RQ = QT / kWarps;
  constexpr int kStage = ring_stage_floats<QT>();
  constexpr int kCopies = (kChunk + QT) * (kSlab / 4);  // 16-byte copies a stage
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int b0 = blockIdx.y * QT;
  const int64_t item0 = int64_t(blockIdx.x) * kChunk;

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
}

// A lane's keys of one query from its scores of the chunk's items
// lane + 32j (-inf at or past n_total), sorted descending.
__device__ __forceinline__ void lane_keys(const float (&acc)[kPerLane],
                                          int64_t n_total,
                                          uint64_t (&key)[kPerLane]) {
  const int64_t item0 = int64_t(blockIdx.x) * kChunk + (threadIdx.x & 31);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int64_t item = item0 + 32 * j;
    const float s = item < n_total ? acc[j] : -__int_as_float(0x7f800000);
    key[j] = make_key(s, uint32_t(item));
  }
  sort8_desc(key);
}

// Stage 1, kc <= kSelMax. grid = (n_chunks, b_pad / QT), block = kThreads;
// ws: [b_pad, n_chunks, kc] keys, each list sorted descending. After
// score_tile, kc rounds each take the warp's largest head: lane `round`
// keeps it and the winning lane pops it.
template <int QT>
__global__ void __launch_bounds__(kThreads, 2)
topk_select(const float* __restrict__ q, const int* __restrict__ rows,
            int64_t q_rows, const float* __restrict__ items, int64_t n_items,
            int dim, int64_t n_total, int kc, int n_chunks,
            uint64_t* __restrict__ ws) {
  constexpr int RQ = QT / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t qrow[QT];
  float acc[RQ][kPerLane];
  score_tile<QT>(q, rows, q_rows, items, n_items, dim,
                 reinterpret_cast<float*>(smem), qrow, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * QT;
  uint64_t key[RQ][kPerLane];
#pragma unroll
  for (int r = 0; r < RQ; ++r) lane_keys(acc[r], n_total, key[r]);

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
      ws[(int64_t(b0 + warp * RQ + r) * n_chunks + blockIdx.x) * kc + lane] =
          out[r];
  }
}

__device__ __forceinline__ uint64_t shfl_xor64(uint64_t v, int mask) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, uint32_t(v), mask);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, uint32_t(v >> 32), mask);
  return (uint64_t(hi) << 32) | lo;
}

// `upper` keeps the smaller of its key and the partner's, the other side
// the larger.
__device__ __forceinline__ uint64_t keep(uint64_t mine, uint64_t other,
                                         bool upper) {
  return (mine > other) != upper ? mine : other;
}

// The warp's 256 keys at positions 8 * lane + j, each lane's 8 sorted
// descending, sorted descending across the warp. Blocks of 8m positions
// (m = 1, 2, .., 16 lanes) merge into blocks of 16m: a flip step pairs
// position i with its mirror i ^ (16m - 1) (lane ^ (2m - 1), register
// 7 - j), then half-cleaners pair i with i ^ 8s (lane ^ s, s = m/2 .. 1)
// and i ^ 4, ^ 2, ^ 1 within the lane; the lower position keeps the larger
// key. tests/test_torch_topk_merge.py models this schedule in numpy.
__device__ __forceinline__ void warp_sort256_desc(uint64_t (&k)[kPerLane],
                                                  int lane) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const bool upper = (lane & m) != 0;
#pragma unroll
    for (int j = 0; j < kPerLane / 2; ++j) {
      const int jm = kPerLane - 1 - j;
      // the partner's k[jm] mirrors my k[j], its k[j] my k[jm]
      const uint64_t a = shfl_xor64(k[jm], 2 * m - 1);
      const uint64_t b = shfl_xor64(k[j], 2 * m - 1);
      k[j] = keep(k[j], a, upper);
      k[jm] = keep(k[jm], b, upper);
    }
#pragma unroll
    for (int s = m >> 1; s > 0; s >>= 1) {
      const bool up = (lane & s) != 0;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) k[j] = keep(k[j], shfl_xor64(k[j], s), up);
    }
    order_desc(k[0], k[4]); order_desc(k[1], k[5]);
    order_desc(k[2], k[6]); order_desc(k[3], k[7]);
    order_desc(k[0], k[2]); order_desc(k[1], k[3]);
    order_desc(k[4], k[6]); order_desc(k[5], k[7]);
    order_desc(k[0], k[1]); order_desc(k[2], k[3]);
    order_desc(k[4], k[5]); order_desc(k[6], k[7]);
  }
}

// Slot of sorted position p in a warp's 256-key staging row: p ^ (p/8 %
// 8) keeps lane l's writes of p = 8l + j to two lanes a bank pair and the
// reads of p = 32i + l conflict-free.
__device__ __forceinline__ int stage_slot(int p) {
  return p ^ ((p >> 3) & 7);
}

// Stage 1, kc > kSelMax: topk_select's arguments and lists. After
// score_tile the warp makes and sorts each of its queries' 256 keys in
// registers, one query at a time, then turns them around through its own
// 2 KB of the idle ring so that the first kc go out in coalesced stores
// (lane l writes positions l, l+32, ..).
template <int QT>
__global__ void __launch_bounds__(kThreads, 2)
topk_sort(const float* __restrict__ q, const int* __restrict__ rows,
          int64_t q_rows, const float* __restrict__ items, int64_t n_items,
          int dim, int64_t n_total, int kc, int n_chunks,
          uint64_t* __restrict__ ws) {
  constexpr int RQ = QT / kWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int64_t qrow[QT];
  float acc[RQ][kPerLane];
  score_tile<QT>(q, rows, q_rows, items, n_items, dim,
                 reinterpret_cast<float*>(smem), qrow, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * QT;
  uint64_t* staged = reinterpret_cast<uint64_t*>(smem) + warp * kChunk;
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    uint64_t key[kPerLane];
    lane_keys(acc[r], n_total, key);
    warp_sort256_desc(key, lane);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      staged[stage_slot(lane * kPerLane + j)] = key[j];
    __syncwarp();
    uint64_t* dst =
        ws + (int64_t(b0 + warp * RQ + r) * n_chunks + blockIdx.x) * kc;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int p = 32 * i + lane;
      if (p < kc) dst[p] = staged[stage_slot(p)];
    }
    __syncwarp();
  }
}

// Length of list `li` of a group of `chunks` chunks whose lists cover
// `span` chunks each (each chunk contributes kc keys; lists cap at k_pad).
__device__ __forceinline__ int list_len(int li, int span, int chunks, int kc,
                                        int k_pad) {
  const int c = min(span, chunks - li * span);
  return int(min(int64_t(c) * kc, int64_t(k_pad)));
}

// One merge level: the n lists in s (at `stride`) merged pairwise into t
// (at min(2 * stride, k_pad)); a list without a partner is copied.
__device__ __forceinline__ void merge_level(const uint64_t* s, uint64_t* t,
                                            int n, int stride, int span,
                                            int chunks, int kc, int k_pad) {
  const int out_stride = min(2 * stride, k_pad);
  const int work = n * stride;
  for (int e = threadIdx.x; e < work; e += kThreads) {
    const int li = e / stride;
    const int p = e - li * stride;
    if (p >= list_len(li, span, chunks, kc, k_pad)) continue;
    const uint64_t key = s[e];
    int pos = p;
    const int other = li ^ 1;
    if (other < n)
      pos += count_greater(s + other * stride,
                           list_len(other, span, chunks, kc, k_pad), key);
    if (pos < out_stride) t[(li >> 1) * out_stride + pos] = key;
  }
}

// Loads n lists (at `stride`, each covering `span` of the group's `chunks`
// chunks) from src into s and merges them pairwise, level by level,
// ping-ponging with u; returns the merged list (in s or u).
__device__ __forceinline__ const uint64_t* merge_in_smem(
    const uint64_t* src, uint64_t* s, uint64_t* u, int n, int stride,
    int span, int chunks, int kc, int k_pad) {
  // the full lists, then the last one's keys (it may be short, and end
  // the row)
  const int size = (n - 1) * stride + list_len(n - 1, span, chunks, kc, k_pad);
  for (int e = threadIdx.x; e < size; e += kThreads) s[e] = src[e];
  __syncthreads();
  while (n > 1) {
    merge_level(s, u, n, stride, span, chunks, kc, k_pad);
    __syncthreads();
    uint64_t* tmp = s; s = u; u = tmp;
    n = (n + 1) >> 1;
    stride = min(2 * stride, k_pad);
    span <<= 1;
  }
  return s;
}

// Row b's result from its merged list: packed [b_pad, 2 k_pad] f32 (scores,
// then ids as f32) when `packed` is not null, else vals and ids
// [b_pad, k_pad].
__device__ __forceinline__ void write_result(const uint64_t* list, int64_t b,
                                             int k_pad, float* packed,
                                             float* vals, int* ids) {
  for (int r = threadIdx.x; r < k_pad; r += kThreads) {
    const uint64_t key = list[r];
    const float v = key_score(key);
    const bool finite = (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
    const int id = finite ? key_id(key) : -1;
    if (packed != nullptr) {
      packed[b * 2 * k_pad + r] = v;
      packed[b * 2 * k_pad + k_pad + r] = float(id);
    } else {
      vals[b * k_pad + r] = v;
      ids[b * k_pad + r] = id;
    }
  }
}

// Stage 2, one round. grid = (b_pad, n_groups), block = kThreads. Row b's
// lists start at src_all + b * row_len, list i at i * stride, each covering
// `span` chunks; CTA (b, g) merges lists g*group .. g*group+group-1 into
// list g of dst (at min(group * stride, k_pad)), or, when the round has one
// group, into the result. In shared memory (2 * group * stride keys) the
// CTA runs levels until one list is left; from the workspace, group is 2
// and the one level writes dst.
template <bool kInSmem>
__global__ void __launch_bounds__(kThreads, kMergeCtasPerSm)
topk_merge_round(const uint64_t* __restrict__ src_all,
                 uint64_t* __restrict__ dst_all, int64_t row_len,
                 int n_chunks, int kc, int k_pad, int span, int stride,
                 int group, float* __restrict__ packed,
                 float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t b = blockIdx.x;
  const int g = blockIdx.y;
  const int64_t chunk0 = int64_t(g) * group * span;
  const int chunks = int(min(int64_t(group) * span, n_chunks - chunk0));
  const int n = (chunks + span - 1) / span;
  const int out_stride = int(min(int64_t(group) * stride, int64_t(k_pad)));
  const uint64_t* src = src_all + b * row_len + int64_t(g) * group * stride;
  uint64_t* dst = dst_all + b * row_len + int64_t(g) * out_stride;

  const uint64_t* res = src;
  if (kInSmem) {
    uint64_t* s = reinterpret_cast<uint64_t*>(smem);
    res = merge_in_smem(src, s, s + group * stride, n, stride, span, chunks,
                        kc, k_pad);
  } else if (n > 1) {
    merge_level(src, dst, n, stride, span, chunks, kc, k_pad);
    __syncthreads();
    res = dst;
  }
  if (gridDim.y == 1) {
    write_result(res, b, k_pad, packed, vals, ids);
  } else if (res != dst) {
    const int len = list_len(0, chunks, chunks, kc, k_pad);
    for (int r = threadIdx.x; r < len; r += kThreads) dst[r] = res[r];
  }
}

template <int QT>
cudaError_t launch_stage1(const float* q, const int* rows, int64_t q_rows,
                          int b_pad, const float* items, int64_t n_items,
                          int dim, int64_t n_total, int kc, int n_chunks,
                          uint64_t* ws, cudaStream_t stream) {
  dim3 grid(n_chunks, b_pad / QT);
  if (kc <= kSelMax)
    topk_select<QT><<<grid, kThreads, ring_smem_bytes<QT>(), stream>>>(
        q, rows, q_rows, items, n_items, dim, n_total, kc, n_chunks, ws);
  else
    topk_sort<QT><<<grid, kThreads, ring_smem_bytes<QT>(), stream>>>(
        q, rows, q_rows, items, n_items, dim, n_total, kc, n_chunks, ws);
  return cudaGetLastError();
}

// Lists a merge CTA takes this round: all that are left once they fit the
// ceiling (in the first round only if the rows alone come within 3/4 of
// one CTA an SM); else as many as fit kMergeTarget, in the first round no
// more than leave one CTA an SM, and at least 2.
// tests/test_torch_topk_merge.py::merge_plan mirrors this rule.
int merge_group(int n_lists, int stride, int b_pad, bool first) {
  const int64_t per_list = 2 * int64_t(stride) * int64_t(sizeof(uint64_t));
  const bool filled = !first || 4 * int64_t(b_pad) >= 3 * int64_t(g_sm_count);
  if (filled && n_lists * per_list <= kMergeSmemMax) return n_lists;
  int64_t g = kMergeTarget / per_list;
  if (!filled) {
    const int64_t want = (g_sm_count + b_pad - 1) / b_pad;
    g = g < n_lists / want ? g : n_lists / want;
  }
  const int64_t floor = (n_lists + kMaxGroups - 1) / kMaxGroups;
  g = g > floor ? g : floor;
  g = g > 2 ? g : 2;
  return int(g < n_lists ? g : n_lists);
}

// Launches the merge rounds; adds each launch to *rounds.
cudaError_t launch_merge(uint64_t* lists, uint64_t* spare, int b_pad,
                         int n_chunks, int kc, int k_pad, float* packed,
                         float* vals, int* ids, int* rounds,
                         cudaStream_t stream) {
  const int64_t row_len = int64_t(n_chunks) * kc;
  uint64_t* src = lists;
  uint64_t* dst = spare;
  int n_lists = n_chunks, stride = kc, span = 1;
  for (bool first = true;; first = false) {
    int group = merge_group(n_lists, stride, b_pad, first);
    const int64_t smem = 2 * int64_t(group) * stride * sizeof(uint64_t);
    const bool in_smem = smem <= kMergeSmemMax;
    if (!in_smem) group = n_lists < 2 ? n_lists : 2;
    const int n_groups = (n_lists + group - 1) / group;
    if (n_groups > kMaxGroups) return cudaErrorInvalidValue;
    dim3 grid(b_pad, n_groups);
    if (in_smem)
      topk_merge_round<true><<<grid, kThreads, size_t(smem), stream>>>(
          src, dst, row_len, n_chunks, kc, k_pad, span, stride, group,
          packed, vals, ids);
    else
      topk_merge_round<false><<<grid, kThreads, 0, stream>>>(
          src, dst, row_len, n_chunks, kc, k_pad, span, stride, group,
          packed, vals, ids);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*rounds;
    if (n_groups == 1) return err;
    n_lists = n_groups;
    span *= group;
    stride = int(int64_t(group) * stride < k_pad ? int64_t(group) * stride
                                                 : k_pad);
    uint64_t* tmp = src; src = dst; dst = tmp;
  }
}

}  // namespace

extern "C" {

// Workspace size in 64-bit keys for one call: two [b_pad, n_chunks, kc]
// buffers (stage-1 lists and the merge rounds' ping-pong partner).
long long pio_topk_workspace(int b_pad, long long n_items, int k_pad) {
  const long long n_chunks = (n_items + kChunk - 1) / kChunk;
  const long long kc = k_pad < kChunk ? k_pad : kChunk;
  return 2LL * b_pad * n_chunks * kc;
}

// Raises the dynamic shared-memory ceilings and reads the current device's
// SM count; call once after loading.
int pio_topk_init() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&g_sm_count, cudaDevAttrMultiProcessorCount,
                               dev);
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_select<8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_smem_bytes<8>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_select<16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_smem_bytes<16>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_select<32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_smem_bytes<32>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_sort<8>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_smem_bytes<8>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_sort<16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_smem_bytes<16>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_sort<32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ring_smem_bytes<32>());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(topk_merge_round<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMergeSmemMax);
  return int(err);
}

// One top-k call on `stream`. rows == null: query b is q row b (q has b_pad
// rows). rows != null: query b is q row rows[b]; an out-of-range row scores as
// a zero query. Writes packed [b_pad, 2 k_pad] f32 (scores, then ids as f32)
// when `packed` is not null, else vals [b_pad, k_pad] f32 and ids
// [b_pad, k_pad] int32. Adds the kernels it launched to launched[0]
// (topk_select), launched[1] (topk_sort) and launched[2] (merge rounds).
// Returns a cudaError_t.
int pio_topk(const float* q, const int* rows, long long q_rows, int b_pad,
             const float* items, long long n_items, int dim, long long n_total,
             int k_pad, unsigned long long* ws, float* packed, float* vals,
             int* ids, void* stream_ptr, int* launched) {
  if (b_pad <= 0 || b_pad % 8 != 0 || dim <= 0 || dim % kSlab != 0 ||
      n_items <= 0 || n_items >= (1LL << 32) || k_pad <= 0 ||
      k_pad > n_items || k_pad > (1 << 29) || n_total > n_items)
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
    err = launch_stage1<32>(q, rows, q_rows, b_pad, items, n_items, dim,
                            n_total, kc, n_chunks, lists, stream);
  else if (b_pad % 16 == 0)
    err = launch_stage1<16>(q, rows, q_rows, b_pad, items, n_items, dim,
                            n_total, kc, n_chunks, lists, stream);
  else
    err = launch_stage1<8>(q, rows, q_rows, b_pad, items, n_items, dim,
                           n_total, kc, n_chunks, lists, stream);
  if (err != cudaSuccess) return int(err);
  ++launched[kc <= kSelMax ? 0 : 1];
  return int(launch_merge(lists, spare, b_pad, n_chunks, kc, k_pad, packed,
                          vals, ids, launched + 2, stream));
}

}  // extern "C"
