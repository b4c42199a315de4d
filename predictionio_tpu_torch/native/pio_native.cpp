// pio_native: host-side runtime kernels for the TPU-native PredictionIO.
//
// The reference's host-side data plane is JVM-native: Spark's shuffle
// machinery lays ratings out into ALS in/out-link blocks, and HBase's
// TableInputFormat scans event rows into the executors
// (hbase/HBPEvents.scala:99, HBEventsUtil.scala:74-134). This library is
// that substrate's C++ equivalent for the TPU build: it prepares data on
// the host so the device only ever sees fixed-shape arrays.
//
//   - pio_neighbor_blocks: COO ratings -> padded per-row neighbor blocks
//     (counting sort + deterministic degree-cap subsample). Role of MLlib
//     ALS's InLinkBlock/OutLinkBlock shuffle layout.
//   - pio_hash64_batch: splitmix64-finalized FNV-1a over packed strings.
//     Role of the HBase row-key MD5 prefix (entity -> shard).
//   - pio_scan_jsonl: newline-delimited JSON event scanner extracting
//     top-level field byte-ranges without materializing parse trees. Role
//     of TableInputFormat / FileToEvents ingestion.
//
// C ABI only; bound from Python via ctypes (predictionio_tpu_torch/native).
// Copied from predictionio_tpu/native/pio_native.cpp.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <atomic>
#include <system_error>
#include <thread>
#include <utility>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

// Key for the degree-cap subsample. Must match the numpy fallback in
// predictionio_tpu/ops/neighbors.py bit-for-bit:
//   key = splitmix64(splitmix64(seed + row) + pos_in_row)
inline uint64_t subsample_key(uint64_t seed, uint64_t row, uint64_t pos) {
  return splitmix64(splitmix64(seed + row) + pos);
}

// Thread count for data-parallel host passes; 1 for small inputs.
inline int64_t thread_count(int64_t n) {
  if (n < (int64_t{1} << 16)) return 1;
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = hw ? static_cast<int64_t>(hw) : 4;
  return std::min<int64_t>(nt, 8);
}

// Run fn(t) for t in [0, nt): [1, nt) on spawned threads, chunk 0
// inline. Thread-resource exhaustion degrades to inline execution —
// std::system_error must never escape the C ABI (std::terminate would
// kill the embedding Python process instead of falling back to numpy).
template <typename F>
inline void run_parallel(int64_t nt, F&& fn) {
  std::vector<std::thread> ts;
  for (int64_t t = 1; t < nt; ++t) {
    try {
      ts.emplace_back(fn, t);
    } catch (const std::system_error&) {
      fn(t);
    }
  }
  fn(0);
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Neighbor blocks
// ---------------------------------------------------------------------------
// rows[n] (int64, 0..num_rows-1), cols[n] (int32), vals[n] (f32).
// Outputs are caller-allocated, ZERO-INITIALIZED row-major [padded_rows, d]
// (padded_rows >= num_rows); mask_out may be NULL (validity is derivable
// as vals != 0 when the caller nudges genuine zero values to an epsilon). Entries beyond the per-row degree cap d are
// dropped by keeping the d smallest (subsample_key, pos) pairs, preserving
// the original relative order of kept entries. Returns the number of
// dropped entries, or -1 on bad input.
int64_t pio_neighbor_blocks(const int64_t* rows, const int32_t* cols,
                            const float* vals, int64_t n, int64_t num_rows,
                            int64_t d, uint64_t seed, int32_t* ids_out,
                            float* vals_out, float* mask_out) {
  if (n < 0 || num_rows < 0 || d <= 0) return -1;
  // per-thread row histograms: the count AND the stable scatter both
  // parallelize with per-(thread, row) write bases — the layout builder
  // calls this per tier over pre-grouped entries, so the no-overflow
  // path below carries ~all of a 100M-rating build's fill cost
  int64_t nt = thread_count(n);
  while (nt > 1 && nt * num_rows > (int64_t{1} << 26)) nt /= 2;
  const int64_t chunk = (n + nt - 1) / nt;
  // every allocation is inside this try: bad_alloc must surface as -1
  // (numpy fallback), never std::terminate through the C ABI
  try {
  std::vector<int64_t> tcounts(static_cast<size_t>(nt) * num_rows, 0);
  std::atomic<int32_t> bad{0};
  run_parallel(nt, [&](int64_t t) {
    int64_t* c = tcounts.data() + t * num_rows;
    const int64_t lo = t * chunk, hi = std::min(n, (t + 1) * chunk);
    for (int64_t i = lo; i < hi; ++i) {
      int64_t r = rows[i];
      if (r < 0 || r >= num_rows) {
        bad.store(1, std::memory_order_relaxed);
        return;
      }
      ++c[r];
    }
  });
  if (bad.load()) return -1;

  std::vector<int64_t> counts(static_cast<size_t>(num_rows), 0);
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t* c = tcounts.data() + t * num_rows;
    for (int64_t r = 0; r < num_rows; ++r) counts[r] += c[r];
  }

  int64_t dropped = 0;

  // Overflow rows need a per-row selection; collect their entry indices.
  // Overflow is rare (heavy-tailed degree distributions), so a sparse map
  // from row -> entries keeps this O(n) in the common case.
  std::vector<int64_t> overflow_rows;
  for (int64_t r = 0; r < num_rows; ++r)
    if (counts[static_cast<size_t>(r)] > d) overflow_rows.push_back(r);

  if (overflow_rows.empty()) {
    // per-(thread, row) write base: row r's d-slot block is filled by
    // threads in chunk order, each thread's entries in stream order —
    // the same stable layout as the sequential fill
    for (int64_t r = 0; r < num_rows; ++r) {
      int64_t running = r * d;
      for (int64_t t = 0; t < nt; ++t) {
        int64_t& c = tcounts[t * num_rows + r];
        const int64_t cnt = c;
        c = running;
        running += cnt;
      }
    }
    run_parallel(nt, [&](int64_t t) {
      int64_t* base = tcounts.data() + t * num_rows;
      const int64_t lo = t * chunk, hi = std::min(n, (t + 1) * chunk);
      for (int64_t i = lo; i < hi; ++i) {
        const int64_t slot = base[rows[i]]++;
        ids_out[slot] = cols[i];
        vals_out[slot] = vals[i];
        if (mask_out) mask_out[slot] = 1.0f;
      }
    });
    return 0;
  }

  std::vector<int64_t> cursor(static_cast<size_t>(num_rows), 0);

  // Mark overflow membership for O(1) routing in the scatter pass.
  std::vector<int64_t> overflow_slot(static_cast<size_t>(num_rows), -1);
  for (size_t k = 0; k < overflow_rows.size(); ++k)
    overflow_slot[static_cast<size_t>(overflow_rows[k])] =
        static_cast<int64_t>(k);
  std::vector<std::vector<int64_t>> pending(overflow_rows.size());
  for (size_t k = 0; k < overflow_rows.size(); ++k)
    pending[k].reserve(
        static_cast<size_t>(counts[static_cast<size_t>(overflow_rows[k])]));

  for (int64_t i = 0; i < n; ++i) {
    int64_t r = rows[i];
    int64_t ov = overflow_slot[static_cast<size_t>(r)];
    if (ov < 0) {
      int64_t slot = r * d + cursor[static_cast<size_t>(r)]++;
      ids_out[slot] = cols[i];
      vals_out[slot] = vals[i];
      if (mask_out) mask_out[slot] = 1.0f;
    } else {
      pending[static_cast<size_t>(ov)].push_back(i);
    }
  }

  std::vector<std::pair<uint64_t, int64_t>> keyed;
  std::vector<char> keep;
  for (size_t k = 0; k < overflow_rows.size(); ++k) {
    const int64_t r = overflow_rows[k];
    const std::vector<int64_t>& idx = pending[k];
    const int64_t cnt = static_cast<int64_t>(idx.size());
    keyed.clear();
    keyed.reserve(idx.size());
    for (int64_t j = 0; j < cnt; ++j)
      keyed.emplace_back(
          subsample_key(seed, static_cast<uint64_t>(r), static_cast<uint64_t>(j)), j);
    std::nth_element(keyed.begin(), keyed.begin() + (d - 1), keyed.end());
    keep.assign(static_cast<size_t>(cnt), 0);
    for (int64_t j = 0; j < d; ++j)
      keep[static_cast<size_t>(keyed[static_cast<size_t>(j)].second)] = 1;
    int64_t c = 0;
    for (int64_t j = 0; j < cnt; ++j) {
      if (!keep[static_cast<size_t>(j)]) continue;
      int64_t i = idx[static_cast<size_t>(j)];
      int64_t slot = r * d + c++;
      ids_out[slot] = cols[i];
      vals_out[slot] = vals[i];
      if (mask_out) mask_out[slot] = 1.0f;
    }
    dropped += cnt - d;
  }
  return dropped;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

// ---------------------------------------------------------------------------
// Stable counting argsort (bounded keys)
// ---------------------------------------------------------------------------
// keys[n] non-negative int32 in [0, key_max]; out[n] receives the
// permutation with keys[out] ascending, ties in original order —
// bit-identical to np.argsort(kind="stable"). The layout builder's two
// entry-stream sorts (tier grouping, heavy-row grouping) are over keys
// bounded by tier count / row count, so a single counting pass replaces
// numpy's single-threaded comparison sort (the dominant host cost of a
// 100M-rating layout build). Parallel scheme: per-thread histograms over
// contiguous chunks, (key-major, thread-minor) exclusive scan so each
// thread owns a stable output range per key, then an in-order scatter.
// Returns 0, or -1 on a key outside [0, key_max].
int32_t pio_counting_argsort_i32(const int32_t* keys, int64_t n,
                                 int64_t key_max, int64_t* out) {
  if (n < 0 || key_max < 0) return -1;
  if (n == 0) return 0;
  const int64_t nk = key_max + 1;
  // counting sort only pays when the key space is comparable to n; a
  // huge sparse key space belongs to a comparison sort (numpy fallback)
  if (nk > (int64_t{1} << 26) || nk > 4 * n + 1024) return -1;
  int64_t nt = thread_count(n);
  // bound total histogram memory (nt * nk int64s) to ~512 MB
  while (nt > 1 && nt * nk > (int64_t{1} << 26)) nt /= 2;
  const int64_t chunk = (n + nt - 1) / nt;
  std::vector<int64_t> hist;
  try {
    hist.assign(static_cast<size_t>(nt) * nk, 0);
  } catch (const std::bad_alloc&) {
    return -1;  // caller falls back to numpy; never abort through ctypes
  }
  std::atomic<int32_t> bad{0};

  auto count_range = [&](int64_t t) {
    int64_t* h = hist.data() + t * nk;
    const int64_t lo = t * chunk, hi = std::min(n, (t + 1) * chunk);
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t k = keys[i];
      if (k < 0 || k > key_max) {
        bad.store(1, std::memory_order_relaxed);
        return;
      }
      ++h[k];
    }
  };
  run_parallel(nt, count_range);
  if (bad.load()) return -1;
  // exclusive scan in (key, thread) order: thread t's output base for
  // key k follows every smaller key and every earlier thread's k-count
  int64_t run = 0;
  for (int64_t k = 0; k < nk; ++k) {
    for (int64_t t = 0; t < nt; ++t) {
      int64_t& h = hist[t * nk + k];
      const int64_t c = h;
      h = run;
      run += c;
    }
  }
  auto scatter_range = [&](int64_t t) {
    int64_t* h = hist.data() + t * nk;
    const int64_t lo = t * chunk, hi = std::min(n, (t + 1) * chunk);
    for (int64_t i = lo; i < hi; ++i) out[h[keys[i]]++] = i;
  };
  run_parallel(nt, scatter_range);
  return 0;
}

// ---------------------------------------------------------------------------
// Hash sharding
// ---------------------------------------------------------------------------
// n strings packed into buf with n+1 offsets; out[i] = 64-bit hash of
// string i, seeded. FNV-1a inner loop, splitmix64 finalizer.
void pio_hash64_batch(const uint8_t* buf, const int64_t* offsets, int64_t n,
                      uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = 0xCBF29CE484222325ULL ^ seed;
    for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
      h ^= buf[j];
      h *= 0x100000001B3ULL;
    }
    out[i] = splitmix64(h);
  }
}

// ---------------------------------------------------------------------------
// JSONL event scanner
// ---------------------------------------------------------------------------
// Scans newline-delimited JSON objects, recording the byte-range of each
// known top-level field's raw value (string values include their quotes).
// Nested objects/arrays are range-tracked, not parsed — the Python side
// json-decodes only the tiny fragments it needs. Unknown keys are skipped.
//
// Field slots (NFIELDS per line; start==end==0 means absent):
//   0 event, 1 entityType, 2 entityId, 3 targetEntityType,
//   4 targetEntityId, 5 eventTime, 6 prId, 7 eventId, 8 creationTime,
//   9 properties, 10 tags
// Returns lines parsed, or -(line_index+1) on a malformed line (the caller
// falls back to its full JSON parser).

namespace {

constexpr int kNFields = 11;

struct FieldName {
  const char* name;
  int64_t len;
};

const FieldName kFields[kNFields] = {
    {"event", 5},          {"entityType", 10}, {"entityId", 8},
    {"targetEntityType", 16}, {"targetEntityId", 14}, {"eventTime", 9},
    {"prId", 4},           {"eventId", 7},     {"creationTime", 12},
    {"properties", 10},    {"tags", 4},
};

struct Scanner {
  const char* p;
  const char* end;

  bool eof() const { return p >= end; }
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  }
  // Cursor sits on '"'. Advances past the closing quote. Returns false on
  // malformed input. [*s, *e) = interior (no quotes).
  bool scan_string(const char** s, const char** e) {
    if (eof() || *p != '"') return false;
    ++p;
    *s = p;
    while (p < end) {
      if (*p == '\\') {
        p += 2;
        continue;
      }
      if (*p == '"') {
        *e = p;
        ++p;
        return true;
      }
      // raw control characters are invalid JSON (strict parsers reject
      // them) — fall back rather than diverge from the full parser
      if (static_cast<unsigned char>(*p) < 0x20) return false;
      ++p;
    }
    return false;
  }
  // Cursor on first char of a value. Advances past it. [*s, *e) = raw
  // value bytes (strings keep their quotes).
  bool scan_value(const char** s, const char** e) {
    skip_ws();
    if (eof()) return false;
    *s = p;
    if (*p == '"') {
      const char* is;
      const char* ie;
      if (!scan_string(&is, &ie)) return false;
      *e = p;
      return true;
    }
    if (*p == '{' || *p == '[') {
      int depth = 0;
      while (p < end) {
        char c = *p;
        if (c == '"') {
          const char* is;
          const char* ie;
          if (!scan_string(&is, &ie)) return false;
          continue;
        }
        if (c == '{' || c == '[') ++depth;
        if (c == '}' || c == ']') {
          --depth;
          if (depth == 0) {
            ++p;
            *e = p;
            return true;
          }
        }
        if (c == '\n') return false;
        ++p;
      }
      return false;
    }
    // scalar: number / true / false / null
    while (p < end && *p != ',' && *p != '}' && *p != ']' && *p != '\n' &&
           *p != ' ' && *p != '\t' && *p != '\r')
      ++p;
    *e = p;
    return *e > *s && valid_scalar(*s, *e - *s);
  }

  // Strict JSON scalar grammar, so the native path rejects exactly what
  // the full parser rejects (a bare identifier must fall back, not pass).
  static bool valid_scalar(const char* s, int64_t len) {
    if ((len == 4 && memcmp(s, "true", 4) == 0) ||
        (len == 5 && memcmp(s, "false", 5) == 0) ||
        (len == 4 && memcmp(s, "null", 4) == 0))
      return true;
    const char* p = s;
    const char* end = s + len;
    if (p < end && *p == '-') ++p;
    if (p == end || *p < '0' || *p > '9') return false;
    if (*p == '0') {
      ++p;
    } else {
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && *p == '.') {
      ++p;
      if (p == end || *p < '0' || *p > '9') return false;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p;
      if (p < end && (*p == '+' || *p == '-')) ++p;
      if (p == end || *p < '0' || *p > '9') return false;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    return p == end;
  }
};

}  // namespace

int64_t pio_scan_jsonl(const char* buf, int64_t len, int64_t max_lines,
                       int64_t* starts, int64_t* ends) {
  const char* p = buf;
  const char* bend = buf + len;
  int64_t line = 0;
  while (p < bend && line < max_lines) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(bend - p)));
    if (line_end == nullptr) line_end = bend;
    Scanner sc{p, line_end};
    sc.skip_ws();
    if (sc.eof()) {  // blank line
      p = line_end + 1;
      continue;
    }
    int64_t* ls = starts + line * kNFields;
    int64_t* le = ends + line * kNFields;
    for (int f = 0; f < kNFields; ++f) ls[f] = le[f] = 0;
    if (*sc.p != '{') return -(line + 1);
    ++sc.p;
    sc.skip_ws();
    if (!sc.eof() && *sc.p == '}') {
      ++sc.p;
    } else {
      while (true) {
        sc.skip_ws();
        const char* ks;
        const char* ke;
        if (!sc.scan_string(&ks, &ke)) return -(line + 1);
        // an escaped key (e.g. "event") would defeat the raw-byte
        // field match below — punt the whole line to the full parser
        if (memchr(ks, '\\', static_cast<size_t>(ke - ks)) != nullptr)
          return -(line + 1);
        sc.skip_ws();
        if (sc.eof() || *sc.p != ':') return -(line + 1);
        ++sc.p;
        const char* vs;
        const char* ve;
        if (!sc.scan_value(&vs, &ve)) return -(line + 1);
        int64_t klen = ke - ks;
        for (int f = 0; f < kNFields; ++f) {
          if (klen == kFields[f].len && memcmp(ks, kFields[f].name, klen) == 0) {
            ls[f] = vs - buf;
            le[f] = ve - buf;
            break;
          }
        }
        sc.skip_ws();
        if (sc.eof()) return -(line + 1);
        if (*sc.p == ',') {
          ++sc.p;
          continue;
        }
        if (*sc.p == '}') {
          ++sc.p;
          break;
        }
        return -(line + 1);
      }
    }
    sc.skip_ws();
    if (!sc.eof()) return -(line + 1);  // trailing garbage
    ++line;
    p = line_end + 1;
  }
  return line;
}

}  // extern "C"
