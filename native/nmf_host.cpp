// nmf_host — native host-side runtime for nmf_tpu.
//
// The reference's "native layer" is CPU BLAS/LAPACK reached through Julia
// (SURVEY.md §2B); this build's compute-native layer is XLA.  What remains
// host-side — and what this library owns — is the data path that feeds the
// devices: parsing multi-gigabyte sparse matrices (MatrixMarket / raw COO),
// deduplicating and converting to CSR, and sorting the nonzeros into the
// sparse store's CSR order.  All of it
// is multithreaded C++ exposed through a plain C ABI consumed via ctypes
// (no pybind11 dependency).
//
// Build: nmf_tpu.io builds native/build/libnmf_host.so at first use (or
// `make -C native`); it falls back to numpy, with a warning, when the build
// fails.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Threading helper (C++ internals, outside the C ABI)

static unsigned hw_threads() {
  unsigned t = std::thread::hardware_concurrency();
  return t ? t : 4;
}

template <typename F>
static void parallel_for(int64_t n, F&& fn) {  // NOLINT
  unsigned nt = hw_threads();
  if (n < (int64_t)nt * 1024) {
    fn((int64_t)0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (unsigned t = 0; t < nt; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// MatrixMarket loader
//
// Parses a `%%MatrixMarket matrix coordinate real general` file into COO
// arrays.  Two passes: header + entry count, then a multithreaded chunked
// parse (each thread scans from a line boundary).

extern "C" {

struct MtxResult {
  int64_t rows, cols, nnz;
  int32_t* row_idx;  // caller frees via nmf_free
  int32_t* col_idx;
  float* values;
  int32_t error;  // 0 ok; 1 io; 2 format
};

static const char* skip_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

int32_t nmf_load_mtx(const char* path, MtxResult* out) {
  std::memset(out, 0, sizeof(*out));
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out->error = 1;
    return 1;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size);
  if (std::fread(buf.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    out->error = 1;
    return 1;
  }
  std::fclose(f);

  const char* p = buf.data();
  const char* end = p + size;
  bool pattern = false, symmetric = false;
  if (size > 14 && std::strncmp(p, "%%MatrixMarket", 14) == 0) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    std::string header(p, line_end);
    if (header.find("pattern") != std::string::npos) pattern = true;
    if (header.find("symmetric") != std::string::npos) symmetric = true;
    if (header.find("coordinate") == std::string::npos) {
      out->error = 2;
      return 2;
    }
  }
  while (p < end && *p == '%') p = skip_line(p, end);

  long long r = 0, c = 0, nnz = 0;
  {
    char tmp[128];
    const char* q = p;
    size_t len = 0;
    while (q < end && *q != '\n' && len < sizeof(tmp) - 1) tmp[len++] = *q++;
    tmp[len] = 0;
    if (std::sscanf(tmp, "%lld %lld %lld", &r, &c, &nnz) != 3) {
      out->error = 2;
      return 2;
    }
    p = skip_line(p, end);
  }

  int64_t cap = symmetric ? 2 * nnz : nnz;
  int32_t* ri = (int32_t*)std::malloc(cap * sizeof(int32_t));
  int32_t* ci = (int32_t*)std::malloc(cap * sizeof(int32_t));
  float* v = (float*)std::malloc(cap * sizeof(float));

  // Split the data region into chunks on line boundaries.
  unsigned nt = hw_threads();
  std::vector<const char*> starts(nt + 1);
  int64_t data_len = end - p;
  for (unsigned t = 0; t < nt; ++t) {
    const char* s = p + (data_len * t) / nt;
    if (t > 0) {
      while (s < end && *(s - 1) != '\n') ++s;
    }
    starts[t] = s;
  }
  starts[nt] = end;

  std::vector<int64_t> counts(nt, 0);
  std::vector<std::vector<int32_t>> tri(nt), tci(nt);
  std::vector<std::vector<float>> tv(nt);
  std::vector<std::thread> threads;
  std::atomic<int> err{0};
  for (unsigned t = 0; t < nt; ++t) {
    threads.emplace_back([&, t] {
      const char* q = starts[t];
      const char* qe = starts[t + 1];
      auto& lri = tri[t];
      auto& lci = tci[t];
      auto& lv = tv[t];
      while (q < qe) {
        // parse "row col [val]\n"
        char* after;
        long rr = std::strtol(q, &after, 10);
        if (after == q) {
          q = skip_line(q, qe);
          continue;
        }
        q = after;
        long cc = std::strtol(q, &after, 10);
        if (after == q) {
          err = 2;
          return;
        }
        q = after;
        double val = 1.0;
        if (!pattern) {
          val = std::strtod(q, &after);
          q = after;
        }
        q = skip_line(q, qe);
        lri.push_back((int32_t)(rr - 1));
        lci.push_back((int32_t)(cc - 1));
        lv.push_back((float)val);
        if (symmetric && rr != cc) {
          lri.push_back((int32_t)(cc - 1));
          lci.push_back((int32_t)(rr - 1));
          lv.push_back((float)val);
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  if (err) {
    std::free(ri);
    std::free(ci);
    std::free(v);
    out->error = err;
    return err;
  }
  int64_t total = 0;
  for (unsigned t = 0; t < nt; ++t) {
    std::memcpy(ri + total, tri[t].data(), tri[t].size() * sizeof(int32_t));
    std::memcpy(ci + total, tci[t].data(), tci[t].size() * sizeof(int32_t));
    std::memcpy(v + total, tv[t].data(), tv[t].size() * sizeof(float));
    total += (int64_t)tri[t].size();
  }
  out->rows = r;
  out->cols = c;
  out->nnz = total;
  out->row_idx = ri;
  out->col_idx = ci;
  out->values = v;
  out->error = 0;
  return 0;
}

void nmf_free(void* ptr) { std::free(ptr); }

// ---------------------------------------------------------------------------
// COO -> CSR with duplicate summing.
//
// Counting sort on rows (parallel histogram), then per-row sort by column and
// in-place duplicate merge.  Returns the deduped nnz.

int64_t nmf_coo_to_csr(int64_t rows, int64_t nnz, const int32_t* row_idx,
                       const int32_t* col_idx, const float* values,
                       int64_t* indptr /* rows+1 */, int32_t* indices /* nnz */,
                       float* data /* nnz */) {
  std::vector<int64_t> count(rows + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) count[row_idx[i] + 1]++;
  for (int64_t r = 0; r < rows; ++r) count[r + 1] += count[r];
  std::vector<int64_t> pos(count.begin(), count.end() - 1);
  for (int64_t i = 0; i < nnz; ++i) {
    int64_t p = pos[row_idx[i]]++;
    indices[p] = col_idx[i];
    data[p] = values[i];
  }
  // per-row column sort + dedupe (parallel over rows)
  std::vector<int64_t> newlen(rows, 0);
  parallel_for(rows, [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<int32_t, float>> tmp;
    for (int64_t r = lo; r < hi; ++r) {
      int64_t s = count[r], e = count[r + 1];
      tmp.clear();
      for (int64_t i = s; i < e; ++i) tmp.emplace_back(indices[i], data[i]);
      std::sort(tmp.begin(), tmp.end(),
                [](auto& a, auto& b) { return a.first < b.first; });
      int64_t w = s;
      for (size_t i = 0; i < tmp.size(); ++i) {
        if (w > s && indices[w - 1] == tmp[i].first) {
          data[w - 1] += tmp[i].second;
        } else {
          indices[w] = tmp[i].first;
          data[w] = tmp[i].second;
          ++w;
        }
      }
      newlen[r] = w - s;
    }
  });
  // compact
  int64_t w = 0;
  indptr[0] = 0;
  for (int64_t r = 0; r < rows; ++r) {
    int64_t s = count[r];
    if (w != s) {
      std::memmove(indices + w, indices + s, newlen[r] * sizeof(int32_t));
      std::memmove(data + w, data + s, newlen[r] * sizeof(float));
    }
    w += newlen[r];
    indptr[r + 1] = w;
  }
  return w;
}

// ---------------------------------------------------------------------------
// Store-build accelerators (nmf_tpu.ops.sparse_format.build_tiled): the
// stable argsort of the (row, col) keys and applying the order to the three
// entry arrays.  The build logic stays in Python; these functions replace
// only the mechanical loops, each parallel and bounded by memory bandwidth.

// Stable LSD radix argsort of non-negative int64 keys (8-bit digits, passes
// skipped when a digit column is constant).  Parallel histogram + stable
// per-thread scatter: thread t's write offset for digit d is the count of d
// in threads < t plus all smaller digits — slice order is preserved, so the
// sort is stable.
int64_t nmf_argsort64(int64_t n, const int64_t* keys, int64_t* order) {
  if (n <= 0) return 0;
  int64_t maxk = 0;
  for (int64_t i = 0; i < n; ++i)
    if (keys[i] > maxk) maxk = keys[i];
  int passes = 1;
  while (passes < 8 && (maxk >> (8 * passes)) != 0) ++passes;

  // int32 index payload (callers guard n < 2^31) halves the transient
  // footprint: 24 B/key instead of 32 B
  std::vector<int64_t> kbuf_a(keys, keys + n), kbuf_b(n);
  std::vector<int32_t> ibuf_a(n), ibuf_b(n);
  for (int64_t i = 0; i < n; ++i) ibuf_a[i] = (int32_t)i;
  int64_t* ksrc = kbuf_a.data();
  int64_t* kdst = kbuf_b.data();
  int32_t* isrc = ibuf_a.data();
  int32_t* idst = ibuf_b.data();

  unsigned nt = hw_threads();
  int64_t chunk = (n + nt - 1) / nt;
  std::vector<int64_t> hist(nt * 256);
  auto per_thread = [&](auto&& body) {  // body(t) on its own thread
    std::vector<std::thread> th;
    for (unsigned t = 0; t < nt; ++t) th.emplace_back([&body, t] { body(t); });
    for (auto& x : th) x.join();
  };

  for (int p = 0; p < passes; ++p) {
    int shift = 8 * p;
    std::fill(hist.begin(), hist.end(), 0);
    per_thread([&](unsigned t) {
      int64_t lo = (int64_t)t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      int64_t* h = hist.data() + (int64_t)t * 256;
      for (int64_t i = lo; i < hi; ++i) ++h[(ksrc[i] >> shift) & 0xFF];
    });
    // exclusive prefix over (digit, thread)
    int64_t run = 0;
    for (int d = 0; d < 256; ++d) {
      for (unsigned t = 0; t < nt; ++t) {
        int64_t& c = hist[t * 256 + d];
        int64_t tmp = c;
        c = run;
        run += tmp;
      }
    }
    per_thread([&](unsigned t) {
      int64_t lo = (int64_t)t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      int64_t* off = hist.data() + (int64_t)t * 256;
      for (int64_t i = lo; i < hi; ++i) {
        int64_t w = off[(ksrc[i] >> shift) & 0xFF]++;
        kdst[w] = ksrc[i];
        idst[w] = isrc[i];
      }
    });
    std::swap(ksrc, kdst);
    std::swap(isrc, idst);
  }
  for (int64_t i = 0; i < n; ++i) order[i] = isrc[i];
  return 0;
}

// out[i] = src[order[i]] for the three entry arrays in one parallel pass.
void nmf_gather3(int64_t n, const int64_t* order, const int32_t* r,
                 const int32_t* c, const float* v, int32_t* ro, int32_t* co,
                 float* vo) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t o = order[i];
      ro[i] = r[o];
      co[i] = c[o];
      vo[i] = v[o];
    }
  });
}

}  // extern "C"
