// Native host runtime for strsim_tpu_torch: the port's own copy of
// strsim_tpu/native/strsim_host.cpp (the port compiles nothing of the JAX
// package by path). Semantics are the reference's, src/expressions/strsim.rs.
//
// Roles:
//
//  1. Ingestion: UTF-8 byte buffers (offsets + data + validity) and CPython
//     str objects -> padded codepoint tiles + lengths, the device feed
//     format; int8 tiles for all-ASCII columns.
//
//  2. Single-core scalar kernels for all fourteen measures over ragged
//     codepoint columns: (a) the single-core baseline of bench_torch.py, and
//     (b) the exact scorer of the pipeline's host rows (small inputs, rows
//     beyond the bucket ladder), on all cores.
//
//  3. Bucket packing, row equality and the exact f64 finalize + scatter
//     around the device stats.
//
// One change from the JAX package's copy: strsim_pack_bucket writes the
// lengths as [2, n_out] (all of a's, then all of b's), the layout the
// port's kernels read, where the JAX package's writes [n_out, 2].
//
// Build: g++ -O3 -shared -fPIC -ffp-contract=off (native/build.py). No
// external dependencies beyond the optional CPython headers (struct reads
// only, no libpython symbols: the library loads outside a Python process).

#if defined(__has_include)
#if __has_include(<Python.h>)
#define STRSIM_HAVE_PYTHON 1
#include <Python.h>
#endif
#endif

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;
using std::uint32_t;
using std::uint8_t;

// ---------------------------------------------------------------------------
// UTF-8 → UCS4 decode (Arrow string column layout)
// ---------------------------------------------------------------------------

// Decode one UTF-8 string into out (caller guarantees capacity). Returns the
// number of Unicode scalar values. Invalid sequences are decoded permissively
// byte-per-byte (the engine validates upstream; Arrow guarantees valid UTF-8).
inline int64_t decode_utf8_row(const uint8_t* s, int64_t nbytes, int32_t* out) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < nbytes) {
    uint8_t c = s[i];
    uint32_t cp;
    int len;
    if (c < 0x80) {
      cp = c;
      len = 1;
    } else if ((c >> 5) == 0x6) {
      cp = c & 0x1F;
      len = 2;
    } else if ((c >> 4) == 0xE) {
      cp = c & 0x0F;
      len = 3;
    } else if ((c >> 3) == 0x1E) {
      cp = c & 0x07;
      len = 4;
    } else {  // stray continuation byte: emit as-is
      cp = c;
      len = 1;
    }
    if (i + len > nbytes) len = 1, cp = c;
    for (int k = 1; k < len; ++k) cp = (cp << 6) | (s[i + k] & 0x3F);
    out[n++] = static_cast<int32_t>(cp);
    i += len;
  }
  return n;
}

}  // namespace

extern "C" {

// Arrow string column → padded [n, width] int32 tile + [n] lengths.
// offsets: n+1 byte offsets into data. validity: optional (may be null) —
// 1 byte per row, 0 = null → zero-length row. Rows longer than width are an
// error: returns the row index + 1; returns 0 on success.
// Pads out_codes with `pad` beyond each row's length.
namespace {

int64_t decode_rows(const uint8_t* data, const int64_t* offsets,
                    const uint8_t* validity, int64_t lo, int64_t hi,
                    int32_t width, int32_t pad, int32_t* out_codes,
                    int32_t* out_lengths) {
  std::vector<int32_t> scratch;
  for (int64_t r = lo; r < hi; ++r) {
    int32_t* row = out_codes + r * width;
    if (validity && !validity[r]) {
      out_lengths[r] = 0;
      continue;
    }
    int64_t nbytes = offsets[r + 1] - offsets[r];
    const uint8_t* s = data + offsets[r];
    // ASCII fast path: widen bytes directly.
    bool ascii = true;
    if (nbytes <= width) {
      int64_t i = 0;
      for (; i < nbytes; ++i) {
        if (s[i] >= 0x80) {
          ascii = false;
          break;
        }
        row[i] = s[i];
      }
      if (ascii) {
        out_lengths[r] = static_cast<int32_t>(nbytes);
        continue;
      }
      std::fill(row, row + i, pad);  // undo partial ASCII write
    }
    scratch.resize(static_cast<size_t>(nbytes));
    int64_t len = nbytes ? decode_utf8_row(s, nbytes, scratch.data()) : 0;
    if (len > width) return r + 1;
    std::copy(scratch.begin(), scratch.begin() + len, row);
    out_lengths[r] = static_cast<int32_t>(len);
  }
  return 0;
}

}  // namespace

int64_t strsim_decode_utf8_column(const uint8_t* data, const int64_t* offsets,
                                  const uint8_t* validity, int64_t n,
                                  int32_t width, int32_t pad,
                                  int32_t* out_codes, int32_t* out_lengths) {
  // one bulk fill (vectorized) instead of a short per-row fill
  std::fill(out_codes, out_codes + n * (int64_t)width, pad);
  int64_t nthreads =
      std::min<int64_t>((int64_t)std::thread::hardware_concurrency(), 8);
  if (n < 65536 || nthreads <= 1) {
    return decode_rows(data, offsets, validity, 0, n, width, pad, out_codes,
                       out_lengths);
  }
  std::vector<int64_t> rcs(nthreads, 0);
  std::vector<std::thread> pool;
  int64_t chunk = n / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = (t == nthreads - 1) ? n : lo + chunk;
    pool.emplace_back([&, t, lo, hi] {
      rcs[t] = decode_rows(data, offsets, validity, lo, hi, width, pad,
                           out_codes, out_lengths);
    });
  }
  for (auto& th : pool) th.join();
  for (int64_t rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

// Scan an Arrow string column for max codepoint length (to size tiles).
int64_t strsim_utf8_max_chars(const uint8_t* data, const int64_t* offsets,
                              const uint8_t* validity, int64_t n) {
  int64_t maxc = 0;
  for (int64_t r = 0; r < n; ++r) {
    if (validity && !validity[r]) continue;
    int64_t chars = 0;
    for (int64_t i = offsets[r]; i < offsets[r + 1]; ++i)
      chars += (data[i] & 0xC0) != 0x80;  // count non-continuation bytes
    maxc = std::max(maxc, chars);
  }
  return maxc;
}

// Vectorized per-row string equality over padded tiles (the reference's
// a == b byte fast path, src/expressions/strsim.rs:128, lifted to a whole
// column). Pads differ between sides (PAD_A=-1 vs PAD_B=-2) so only the
// first len elements can match; rows are equal iff lengths match and the
// prefix bytes compare equal. elem_bytes: 1 (int8 tiles) or 4 (int32).
int64_t strsim_equal_rows(const void* codes_a, const void* codes_b,
                          const int32_t* len_a, const int32_t* len_b,
                          int64_t n, int32_t width, int32_t elem_bytes,
                          uint8_t* out) {
  auto run = [=](int64_t lo, int64_t hi) {
    const char* base_a = static_cast<const char*>(codes_a);
    const char* base_b = static_cast<const char*>(codes_b);
    int64_t stride = (int64_t)width * elem_bytes;
    for (int64_t r = lo; r < hi; ++r) {
      if (len_a[r] != len_b[r]) {
        out[r] = 0;
        continue;
      }
      out[r] = std::memcmp(base_a + r * stride, base_b + r * stride,
                           (size_t)len_a[r] * elem_bytes) == 0;
    }
  };
  int64_t nthreads =
      std::min<int64_t>((int64_t)std::thread::hardware_concurrency(), 8);
  if (n < 65536 || nthreads <= 1) {
    run(0, n);
    return 0;
  }
  std::vector<std::thread> pool;
  int64_t chunk = n / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = (t == nthreads - 1) ? n : lo + chunk;
    pool.emplace_back(run, lo, hi);
  }
  for (auto& th : pool) th.join();
  return 0;
}

// Gather selected rows of two padded code tiles straight into the packed
// [n_out, 2*width] device staging buffer (a-row | b-row per output row) and
// the [2, n_out] length tile — one threaded pass, no intermediate gathers.
// Rows past n_sel (group-size padding) are pad-filled with zero lengths.
// elem_bytes must match both tiles (1 = int8 ASCII, 4 = int32).
int64_t strsim_pack_bucket(const void* codes_a, const void* codes_b,
                           int32_t w_src, const int32_t* len_a,
                           const int32_t* len_b, const int64_t* sel,
                           int64_t n_sel, int32_t width, int32_t pad_a,
                           int32_t pad_b, int32_t elem_bytes, void* out,
                           int32_t* out_lens, int64_t n_out) {
  int32_t w_copy = std::min(w_src, width);
  auto run = [=](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      char* dst = static_cast<char*>(out) + r * (int64_t)2 * width * elem_bytes;
      if (r >= n_sel) {
        if (elem_bytes == 1) {
          std::memset(dst, (char)pad_a, (size_t)width);
          std::memset(dst + width, (char)pad_b, (size_t)width);
        } else {
          int32_t* d = (int32_t*)dst;
          for (int32_t i = 0; i < width; ++i) d[i] = pad_a;
          for (int32_t i = 0; i < width; ++i) d[width + i] = pad_b;
        }
        out_lens[r] = 0;
        out_lens[n_out + r] = 0;
        continue;
      }
      int64_t s = sel[r];
      const char* ra =
          static_cast<const char*>(codes_a) + s * (int64_t)w_src * elem_bytes;
      const char* rb =
          static_cast<const char*>(codes_b) + s * (int64_t)w_src * elem_bytes;
      std::memcpy(dst, ra, (size_t)w_copy * elem_bytes);
      std::memcpy(dst + (int64_t)width * elem_bytes, rb,
                  (size_t)w_copy * elem_bytes);
      if (width > w_copy) {
        if (elem_bytes == 1) {
          std::memset(dst + w_copy, (char)pad_a, (size_t)(width - w_copy));
          std::memset(dst + width + w_copy, (char)pad_b,
                      (size_t)(width - w_copy));
        } else {
          int32_t* d = (int32_t*)dst;
          for (int32_t i = w_copy; i < width; ++i) d[i] = pad_a;
          for (int32_t i = w_copy; i < width; ++i) d[width + i] = pad_b;
        }
      }
      out_lens[r] = len_a[s];
      out_lens[n_out + r] = len_b[s];
    }
  };
  int64_t nthreads =
      std::min<int64_t>((int64_t)std::thread::hardware_concurrency(), 8);
  if (n_out < 65536 || nthreads <= 1) {
    run(0, n_out);
    return 0;
  }
  std::vector<std::thread> pool;
  int64_t chunk = n_out / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = (t == nthreads - 1) ? n_out : lo + chunk;
    pool.emplace_back(run, lo, hi);
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"

#ifdef STRSIM_HAVE_PYTHON
// ---------------------------------------------------------------------------
// Direct PyUnicode column ingestion
// ---------------------------------------------------------------------------
// The fastest possible host encode: read codepoints straight out of CPython's
// compact unicode representation (PEP 393) into the padded device tile — no
// UTF-8 round-trip, no Python-level join/length passes. Only immutable struct
// fields of objects kept alive by the caller's numpy object array are read;
// no refcounts are touched, so the passes run GIL-released and threaded.
// Type identity is checked against caller-supplied PyObject addresses
// (id(None), id(str)) so the library links without any libpython symbols.

extern "C" {

// Pass 1: per-row codepoint lengths + validity, column max length, ASCII-ness.
// Returns max length (>= 0), or -(r+1) if row r is neither str nor None.
int64_t strsim_scan_object_column(void* const* objs, int64_t n, void* none_obj,
                                  void* str_type, int32_t* out_lengths,
                                  uint8_t* out_validity,
                                  int32_t* out_all_ascii) {
  int64_t nthreads =
      std::min<int64_t>((int64_t)std::thread::hardware_concurrency(), 8);
  if (n < 65536) nthreads = 1;
  std::vector<int64_t> maxs((size_t)nthreads, 0), errs((size_t)nthreads, 0);
  std::vector<int32_t> asciis((size_t)nthreads, 1);
  auto run = [=, &maxs, &errs, &asciis](int64_t t, int64_t lo, int64_t hi) {
    int64_t mx = 0;
    int32_t all_ascii = 1;
    for (int64_t r = lo; r < hi; ++r) {
      PyObject* o = (PyObject*)objs[r];
      if ((void*)o == none_obj) {
        out_lengths[r] = 0;
        out_validity[r] = 0;
        continue;
      }
      // PyUnicode_Check is a tp_flags bit read (Py_TPFLAGS_UNICODE_SUBCLASS)
      // — covers str subclasses like np.str_, whose PyUnicode layout the
      // accessors below handle (subclass instances are legacy/ready strings).
      if (!PyUnicode_Check(o)) {
        errs[(size_t)t] = r + 1;
        return;
      }
      (void)str_type;
      Py_ssize_t len = PyUnicode_GET_LENGTH(o);
      out_lengths[r] = (int32_t)len;
      out_validity[r] = 1;
      if (!PyUnicode_IS_ASCII(o)) all_ascii = 0;
      if (len > mx) mx = len;
    }
    maxs[(size_t)t] = mx;
    asciis[(size_t)t] = all_ascii;
  };
  if (nthreads <= 1) {
    run(0, 0, n);
  } else {
    std::vector<std::thread> pool;
    int64_t chunk = n / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
      int64_t lo = t * chunk;
      int64_t hi = (t == nthreads - 1) ? n : lo + chunk;
      pool.emplace_back(run, t, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  for (int64_t e : errs)
    if (e) return -e;
  int64_t mx = 0;
  int32_t all_ascii = 1;
  for (int64_t t = 0; t < nthreads; ++t) {
    mx = std::max(mx, maxs[(size_t)t]);
    all_ascii &= asciis[(size_t)t];
  }
  *out_all_ascii = all_ascii;
  return mx;
}

// Pass 2: copy codepoints into the padded [n, width] tile.
// elem_bytes 1 writes int8 (caller guarantees an all-ASCII column, pass 1's
// out_all_ascii); elem_bytes 4 writes int32 for any kind. None rows are
// pad-filled (validity handled by the caller). Returns 0, or r+1 if row r
// is longer than width.
int64_t strsim_encode_object_column(void* const* objs, int64_t n,
                                    void* none_obj, int32_t width, int32_t pad,
                                    int32_t elem_bytes, void* out_codes) {
  int64_t nthreads =
      std::min<int64_t>((int64_t)std::thread::hardware_concurrency(), 8);
  if (n < 65536) nthreads = 1;
  std::vector<int64_t> errs((size_t)nthreads, 0);
  auto run = [=, &errs](int64_t t, int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      PyObject* o = (PyObject*)objs[r];
      if (elem_bytes == 1) {
        int8_t* dst = (int8_t*)out_codes + r * width;
        if ((void*)o == none_obj) {
          std::memset(dst, (char)pad, (size_t)width);
          continue;
        }
        Py_ssize_t len = PyUnicode_GET_LENGTH(o);
        if (len > width) {
          errs[(size_t)t] = r + 1;
          return;
        }
        // ASCII column: kind-1 data is the byte string itself
        std::memcpy(dst, PyUnicode_1BYTE_DATA(o), (size_t)len);
        std::memset(dst + len, (char)pad, (size_t)(width - len));
      } else {
        int32_t* dst = (int32_t*)out_codes + r * width;
        if ((void*)o == none_obj) {
          for (int32_t i = 0; i < width; ++i) dst[i] = pad;
          continue;
        }
        Py_ssize_t len = PyUnicode_GET_LENGTH(o);
        if (len > width) {
          errs[(size_t)t] = r + 1;
          return;
        }
        switch (PyUnicode_KIND(o)) {
          case PyUnicode_1BYTE_KIND: {
            const Py_UCS1* s = PyUnicode_1BYTE_DATA(o);
            for (Py_ssize_t i = 0; i < len; ++i) dst[i] = s[i];
            break;
          }
          case PyUnicode_2BYTE_KIND: {
            const Py_UCS2* s = PyUnicode_2BYTE_DATA(o);
            for (Py_ssize_t i = 0; i < len; ++i) dst[i] = s[i];
            break;
          }
          default: {
            std::memcpy(dst, PyUnicode_4BYTE_DATA(o), (size_t)len * 4);
            break;
          }
        }
        for (Py_ssize_t i = len; i < width; ++i) dst[i] = pad;
      }
    }
  };
  if (nthreads <= 1) {
    run(0, 0, n);
  } else {
    std::vector<std::thread> pool;
    int64_t chunk = n / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
      int64_t lo = t * chunk;
      int64_t hi = (t == nthreads - 1) ? n : lo + chunk;
      pool.emplace_back(run, t, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
  for (int64_t e : errs)
    if (e) return e;
  return 0;
}

}  // extern "C"
#endif  // STRSIM_HAVE_PYTHON

// ---------------------------------------------------------------------------
// Scalar similarity kernels over ragged codepoint columns
// ---------------------------------------------------------------------------

namespace {

struct Scratch {
  std::vector<int64_t> dp0, dp1, dp2;
  std::vector<uint8_t> flag_a, flag_b;
  std::vector<int32_t> ord_a, ord_b;
  std::unordered_map<int32_t, std::pair<int32_t, int32_t>> counts;
  // bigram multiset counts: key = (first codepoint << 32) | second
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> counts2;
};

inline bool rows_equal(const int32_t* a, int64_t la, const int32_t* b,
                       int64_t lb) {
  return la == lb && std::memcmp(a, b, la * sizeof(int32_t)) == 0;
}

double lev_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
               Scratch& s) {
  if ((la == 0 && lb == 0) || rows_equal(a, la, b, lb)) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  s.dp0.resize(lb + 1);
  s.dp1.resize(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) s.dp0[j] = j;
  for (int64_t i = 0; i < la; ++i) {
    s.dp1[0] = i + 1;
    int32_t ai = a[i];
    for (int64_t j = 0; j < lb; ++j) {
      int64_t sub = (ai == b[j]) ? s.dp0[j] : s.dp0[j] + 1;
      s.dp1[j + 1] = std::min(sub, std::min(s.dp0[j + 1], s.dp1[j]) + 1);
    }
    std::swap(s.dp0, s.dp1);
  }
  return 1.0 -
         (static_cast<double>(s.dp0[lb]) / static_cast<double>(std::max(la, lb)));
}

// Greedy windowed Jaro match; returns (m, t) and prefix via out-params.
void jaro_stats(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                Scratch& s, int64_t* out_m, int64_t* out_t) {
  int64_t bound = std::max(la, lb) / 2 - 1;
  s.flag_a.assign(la, 0);
  s.flag_b.assign(lb, 0);
  int64_t m = 0;
  int64_t imax = std::min(la, lb + bound);
  for (int64_t i = 0; i < imax; ++i) {
    int64_t lo = std::max<int64_t>(0, i - bound);
    int64_t hi = std::min(i + bound, lb - 1);
    for (int64_t j = lo; j <= hi; ++j) {
      if (a[i] == b[j] && !s.flag_b[j]) {
        ++m;
        s.flag_a[i] = 1;
        s.flag_b[j] = 1;
        break;
      }
    }
  }
  int64_t t = 0;
  int64_t j = 0;
  for (int64_t i = 0; i < la; ++i) {
    if (!s.flag_a[i]) continue;
    while (j < lb && !s.flag_b[j]) ++j;
    if (j < lb && a[i] != b[j]) ++t;
    ++j;
  }
  *out_m = m;
  *out_t = t;
}

double jaro_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                Scratch& s) {
  if ((la == 0 && lb == 0) || rows_equal(a, la, b, lb)) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  if (la == 1 && lb == 1) return a[0] == b[0] ? 1.0 : 0.0;
  int64_t m, t;
  jaro_stats(a, la, b, lb, s, &m, &t);
  if (m == 0) return 0.0;
  double md = static_cast<double>(m);
  return (md / la + md / lb + static_cast<double>(m - t / 2) / md) / 3.0;
}

double jaro_winkler_sim(const int32_t* a, int64_t la, const int32_t* b,
                        int64_t lb, Scratch& s) {
  double js = jaro_sim(a, la, b, lb, s);
  if (js > 0.7) {
    double prefix = 0;
    for (int64_t i = 0; i < std::min<int64_t>(4, std::min(la, lb)); ++i) {
      if (a[i] != b[i]) break;
      prefix += 1.0;
    }
    return js + (prefix * 0.1 * (1.0 - js));
  }
  return js;
}

void count_pair(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                Scratch& s) {
  s.counts.clear();
  for (int64_t i = 0; i < la; ++i) s.counts[a[i]].first++;
  for (int64_t j = 0; j < lb; ++j) s.counts[b[j]].second++;
}

double jaccard_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                   Scratch& s) {
  if ((la == 0 && lb == 0) || rows_equal(a, la, b, lb)) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  count_pair(a, la, b, lb, s);
  int64_t num = 0, den = 0;
  for (auto& kv : s.counts) {
    num += std::min(kv.second.first, kv.second.second);
    den += std::max(kv.second.first, kv.second.second);
  }
  return static_cast<double>(num) / static_cast<double>(den);
}

double dice_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                Scratch& s) {
  if ((la == 0 && lb == 0) || rows_equal(a, la, b, lb)) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  count_pair(a, la, b, lb, s);
  int64_t num = 0;
  for (auto& kv : s.counts) num += std::min(kv.second.first, kv.second.second);
  return 2.0 * static_cast<double>(num) / static_cast<double>(la + lb);
}

// ---- EXTENSION measures (not in the reference; each mirrors the Python
// oracle's f64 evaluation order exactly, ops/oracle.py, so the native host
// fallback stays bit-identical to the oracle/finalizer contract) ----

double cosine_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                  Scratch& s) {
  if ((la == 0 && lb == 0) || rows_equal(a, la, b, lb)) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  count_pair(a, la, b, lb, s);
  int64_t num = 0;
  for (auto& kv : s.counts) num += std::min(kv.second.first, kv.second.second);
  return static_cast<double>(num) / std::sqrt(static_cast<double>(la * lb));
}

double overlap_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                   Scratch& s) {
  if ((la == 0 && lb == 0) || rows_equal(a, la, b, lb)) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  count_pair(a, la, b, lb, s);
  int64_t num = 0;
  for (auto& kv : s.counts) num += std::min(kv.second.first, kv.second.second);
  return static_cast<double>(num) / static_cast<double>(std::min(la, lb));
}

double hamming_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                   Scratch&) {
  if (la == 0 && lb == 0) return 1.0;
  int64_t m = 0;
  int64_t lo = std::min(la, lb);
  for (int64_t i = 0; i < lo; ++i) m += (a[i] == b[i]);
  return static_cast<double>(m) / static_cast<double>(std::max(la, lb));
}

int64_t lcs_len(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                Scratch& s) {
  s.dp0.assign(lb + 1, 0);
  s.dp1.assign(lb + 1, 0);
  for (int64_t i = 0; i < la; ++i) {
    int32_t ai = a[i];
    for (int64_t j = 0; j < lb; ++j) {
      s.dp1[j + 1] =
          (ai == b[j]) ? s.dp0[j] + 1 : std::max(s.dp0[j + 1], s.dp1[j]);
    }
    std::swap(s.dp0, s.dp1);
  }
  return s.dp0[lb];
}

double lcs_seq_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                   Scratch& s) {
  if (la == 0 && lb == 0) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  return static_cast<double>(lcs_len(a, la, b, lb, s)) /
         static_cast<double>(std::max(la, lb));
}

double indel_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                 Scratch& s) {
  if (la == 0 && lb == 0) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  return 2.0 * static_cast<double>(lcs_len(a, la, b, lb, s)) /
         static_cast<double>(la + lb);
}

double osa_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
               Scratch& s) {
  if ((la == 0 && lb == 0) || rows_equal(a, la, b, lb)) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  // restricted Damerau-Levenshtein: classic 3-row DP (dp2 = row i-2)
  s.dp2.assign(lb + 1, 0);
  s.dp0.resize(lb + 1);
  s.dp1.resize(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) s.dp0[j] = j;
  for (int64_t i = 0; i < la; ++i) {
    s.dp1[0] = i + 1;
    int32_t ai = a[i];
    for (int64_t j = 0; j < lb; ++j) {
      int64_t sub = (ai == b[j]) ? s.dp0[j] : s.dp0[j] + 1;
      int64_t d = std::min(sub, std::min(s.dp0[j + 1], s.dp1[j]) + 1);
      if (i > 0 && j > 0 && ai == b[j - 1] && a[i - 1] == b[j])
        d = std::min(d, s.dp2[j - 1] + 1);
      s.dp1[j + 1] = d;
    }
    std::swap(s.dp2, s.dp0);
    std::swap(s.dp0, s.dp1);
  }
  return 1.0 -
         (static_cast<double>(s.dp0[lb]) / static_cast<double>(std::max(la, lb)));
}

void count_bigrams(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                   Scratch& s) {
  s.counts2.clear();
  for (int64_t i = 0; i + 1 < la; ++i)
    s.counts2[(static_cast<uint64_t>(static_cast<uint32_t>(a[i])) << 32) |
              static_cast<uint32_t>(a[i + 1])]
        .first++;
  for (int64_t j = 0; j + 1 < lb; ++j)
    s.counts2[(static_cast<uint64_t>(static_cast<uint32_t>(b[j])) << 32) |
              static_cast<uint32_t>(b[j + 1])]
        .second++;
}

double jaccard_bigram_sim(const int32_t* a, int64_t la, const int32_t* b,
                          int64_t lb, Scratch& s) {
  if (rows_equal(a, la, b, lb)) return 1.0;
  int64_t na = std::max<int64_t>(la - 1, 0);
  int64_t nb = std::max<int64_t>(lb - 1, 0);
  if (na == 0 || nb == 0) return 0.0;
  count_bigrams(a, la, b, lb, s);
  int64_t inter = 0;
  for (auto& kv : s.counts2)
    inter += std::min(kv.second.first, kv.second.second);
  return static_cast<double>(inter) / static_cast<double>(na + nb - inter);
}

double dice_bigram_sim(const int32_t* a, int64_t la, const int32_t* b,
                       int64_t lb, Scratch& s) {
  if (rows_equal(a, la, b, lb)) return 1.0;
  int64_t na = std::max<int64_t>(la - 1, 0);
  int64_t nb = std::max<int64_t>(lb - 1, 0);
  if (na == 0 || nb == 0) return 0.0;
  count_bigrams(a, la, b, lb, s);
  int64_t inter = 0;
  for (auto& kv : s.counts2)
    inter += std::min(kv.second.first, kv.second.second);
  return 2.0 * static_cast<double>(inter) / static_cast<double>(na + nb);
}

// American Soundex with the H/W rule — mirrors ops/phonetic.py's spec and
// the Python oracle (ops/oracle.py:soundex_code) exactly. Returns the packed
// int32 code: first_letter*1000 + d1*100 + d2*10 + d3; 0 = no letters.
int32_t soundex_code(const int32_t* a, int64_t la) {
  // digit class per letter A..Z
  static const int32_t kDigits[26] = {0, 1, 2, 3, 0, 1, 2, 0, 0, 2, 2, 4, 5,
                                      5, 0, 1, 2, 6, 2, 3, 0, 1, 0, 2, 0, 2};
  int32_t first = 0, prev = 0, count = 0, code = 0;
  for (int64_t i = 0; i < la; ++i) {
    int32_t c = a[i];
    int32_t u;
    if (c >= 65 && c <= 90) {
      u = c;
    } else if (c >= 97 && c <= 122) {
      u = c - 32;
    } else {
      continue;  // non-letters are skipped with no effect on state
    }
    int32_t d = kDigits[u - 65];
    if (first == 0) {
      first = u;
      prev = d;
      continue;
    }
    if (d != 0 && d != prev && count < 3) {
      code = code * 10 + d;
      ++count;
    }
    if (u != 'H' && u != 'W') prev = d;  // H/W transparent to "previous"
  }
  if (first == 0) return 0;
  while (count < 3) {
    code *= 10;
    ++count;
  }
  return first * 1000 + code;
}

double soundex_sim(const int32_t* a, int64_t la, const int32_t* b, int64_t lb,
                   Scratch&) {
  if ((la == 0 && lb == 0) || rows_equal(a, la, b, lb)) return 1.0;
  if (la == 0 || lb == 0) return 0.0;
  return soundex_code(a, la) == soundex_code(b, lb) ? 1.0 : 0.0;
}

}  // namespace

extern "C" {

namespace {

// One contiguous row range, one scratch object (the reference gives each
// rayon chunk its own kernel instance, strsim.rs:78-84 — same idea).
void compute_range(int32_t measure, const int32_t* codes_a,
                   const int64_t* off_a, const int32_t* codes_b,
                   const int64_t* off_b, const uint8_t* validity, int64_t lo,
                   int64_t hi, double* out) {
  Scratch s;
  for (int64_t r = lo; r < hi; ++r) {
    if (validity && !validity[r]) {
      out[r] = std::numeric_limits<double>::quiet_NaN();
      continue;
    }
    const int32_t* a = codes_a + off_a[r];
    int64_t la = off_a[r + 1] - off_a[r];
    const int32_t* b = codes_b + off_b[r];
    int64_t lb = off_b[r + 1] - off_b[r];
    switch (measure) {
      case 0: out[r] = lev_sim(a, la, b, lb, s); break;
      case 1: out[r] = jaro_sim(a, la, b, lb, s); break;
      case 2: out[r] = jaro_winkler_sim(a, la, b, lb, s); break;
      case 3: out[r] = jaccard_sim(a, la, b, lb, s); break;
      case 4: out[r] = dice_sim(a, la, b, lb, s); break;
      case 5: out[r] = jaccard_bigram_sim(a, la, b, lb, s); break;
      case 6: out[r] = dice_bigram_sim(a, la, b, lb, s); break;
      case 7: out[r] = cosine_sim(a, la, b, lb, s); break;
      case 8: out[r] = overlap_sim(a, la, b, lb, s); break;
      case 9: out[r] = hamming_sim(a, la, b, lb, s); break;
      case 10: out[r] = lcs_seq_sim(a, la, b, lb, s); break;
      case 11: out[r] = indel_sim(a, la, b, lb, s); break;
      case 12: out[r] = osa_sim(a, la, b, lb, s); break;
      case 13: out[r] = soundex_sim(a, la, b, lb, s); break;
      default: out[r] = -1.0;
    }
  }
}

}  // namespace

// measure: 0=levenshtein 1=jaro 2=jaro_winkler 3=jaccard 4=sorensen_dice
//          5=jaccard_bigram 6=sorensen_dice_bigram 7=cosine 8=overlap
//          9=hamming 10=lcs_seq 11=indel 12=osa 13=soundex (extensions)
// Ragged layout: codes_* concatenated codepoints, off_*: n+1 offsets.
// validity: optional; null rows produce NaN. Single-threaded by design —
// this is the per-core baseline the engine is measured against.
void strsim_compute(int32_t measure, const int32_t* codes_a,
                    const int64_t* off_a, const int32_t* codes_b,
                    const int64_t* off_b, const uint8_t* validity, int64_t n,
                    double* out) {
  compute_range(measure, codes_a, off_a, codes_b, off_b, validity, 0, n, out);
}

namespace {

// NYSIIS phonetic code — mirrors the Python oracle
// (ops/oracle.py:nysiis_code) rule for rule; differentially tested against
// it (tests/test_phonetic.py). Writes the code's chars into out (capacity
// key_width, truncating longer codes) and returns the written length.
int32_t nysiis_code(const int32_t* a, int64_t la, int32_t key_width,
                    uint8_t* out) {
  std::string w;
  w.reserve(la);
  for (int64_t i = 0; i < la; ++i) {
    int32_t c = a[i];
    if (c >= 65 && c <= 90) w.push_back(static_cast<char>(c));
    else if (c >= 97 && c <= 122) w.push_back(static_cast<char>(c - 32));
  }
  if (w.empty()) return 0;
  auto starts = [&](const char* p) { return w.rfind(p, 0) == 0; };
  auto ends = [&](const char* p) {
    size_t l = std::strlen(p);
    return w.size() >= l && w.compare(w.size() - l, l, p) == 0;
  };
  // first-char transforms
  if (starts("MAC")) w.replace(0, 3, "MCC");
  else if (starts("KN")) w.replace(0, 2, "NN");
  else if (starts("K")) w.replace(0, 1, "C");
  else if (starts("PH") || starts("PF")) w.replace(0, 2, "FF");
  else if (starts("SCH")) w.replace(0, 3, "SSS");
  // last-char transforms
  if (ends("EE") || ends("IE")) w.replace(w.size() - 2, 2, "Y");
  else if (ends("DT") || ends("RT") || ends("RD") || ends("NT") || ends("ND"))
    w.replace(w.size() - 2, 2, "D");
  auto is_vowel = [](char c) {
    return c == 'A' || c == 'E' || c == 'I' || c == 'O' || c == 'U';
  };
  std::string key(1, w[0]);
  size_t i = 1, n = w.size();
  while (i < n) {
    char c = w[i];
    size_t step = 1;
    char repbuf[4];
    const char* rep = repbuf;
    repbuf[1] = 0;
    if (c == 'E' && i + 1 < n && w[i + 1] == 'V') {
      rep = "AF";
      step = 2;
    } else if (is_vowel(c)) {
      repbuf[0] = 'A';
    } else if (c == 'Q') {
      repbuf[0] = 'G';
    } else if (c == 'Z') {
      repbuf[0] = 'S';
    } else if (c == 'M') {
      repbuf[0] = 'N';
    } else if (c == 'K') {
      if (i + 1 < n && w[i + 1] == 'N') {
        repbuf[0] = 'N';
        step = 2;
      } else {
        repbuf[0] = 'C';
      }
    } else if (c == 'S' && i + 2 < n && w[i + 1] == 'C' && w[i + 2] == 'H') {
      rep = "SSS";
      step = 3;
    } else if (c == 'P' && i + 1 < n && w[i + 1] == 'H') {
      rep = "FF";
      step = 2;
    } else if (c == 'H' && (!is_vowel(w[i - 1]) ||
                            (i + 1 < n && !is_vowel(w[i + 1])))) {
      repbuf[0] = w[i - 1];
    } else if (c == 'W' && is_vowel(w[i - 1])) {
      repbuf[0] = w[i - 1];
    } else {
      repbuf[0] = c;
    }
    for (const char* r = rep; *r; ++r)
      if (*r != key.back()) key.push_back(*r);
    i += step;
  }
  // terminal cleanup: trailing S, trailing AY -> Y, trailing A
  if (key.size() > 1 && key.back() == 'S') key.pop_back();
  if (key.size() > 2 && key[key.size() - 2] == 'A' && key.back() == 'Y')
    key.erase(key.size() - 2, 1);
  if (key.size() > 1 && key.back() == 'A') key.pop_back();
  int32_t out_len = static_cast<int32_t>(
      std::min<size_t>(key.size(), static_cast<size_t>(key_width)));
  std::memcpy(out, key.data(), out_len);
  return out_len;
}

void phonetic_range(int32_t method, const int32_t* codes, const int64_t* off,
                    const uint8_t* validity, int64_t lo, int64_t hi,
                    int32_t key_width, uint8_t* out, int32_t* out_lens) {
  for (int64_t r = lo; r < hi; ++r) {
    uint8_t* dst = out + r * key_width;
    if (validity && !validity[r]) {
      out_lens[r] = -1;  // null marker
      continue;
    }
    const int32_t* a = codes + off[r];
    int64_t la = off[r + 1] - off[r];
    if (method == 1) {
      out_lens[r] = nysiis_code(a, la, key_width, dst);
    } else {  // method 0: soundex, packed code rendered as chars
      int32_t p = soundex_code(a, la);
      if (p == 0) {
        out_lens[r] = 0;
      } else {
        dst[0] = static_cast<uint8_t>(p / 1000);
        dst[1] = static_cast<uint8_t>('0' + (p / 100) % 10);
        dst[2] = static_cast<uint8_t>('0' + (p / 10) % 10);
        dst[3] = static_cast<uint8_t>('0' + p % 10);
        out_lens[r] = 4;
      }
    }
  }
}

}  // namespace

// Batch phonetic key generation (EXTENSION): method 0 = American Soundex
// (4-char codes), 1 = NYSIIS (variable length, truncated to key_width).
// Ragged layout as strsim_compute; out is [n, key_width] (callers zero it or
// use out_lens), out_lens[r] = code length, -1 for null rows. Threaded.
void strsim_phonetic_codes(int32_t method, const int32_t* codes,
                           const int64_t* off, const uint8_t* validity,
                           int64_t n, int32_t key_width, int32_t threads,
                           uint8_t* out, int32_t* out_lens) {
  int64_t t = threads > 0 ? threads : (int64_t)std::thread::hardware_concurrency();
  if (t <= 1 || n < 4096) {
    phonetic_range(method, codes, off, validity, 0, n, key_width, out, out_lens);
    return;
  }
  t = std::min<int64_t>(t, n);
  std::vector<std::thread> pool;
  pool.reserve(t);
  int64_t chunk = n / t;
  for (int64_t i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = (i == t - 1) ? n : lo + chunk;
    pool.emplace_back(phonetic_range, method, codes, off, validity, lo, hi,
                      key_width, out, out_lens);
  }
  for (auto& th : pool) th.join();
}

// Multi-threaded variant: equal row ranges over `threads` std::threads (the
// engine's host-fallback path; the reference's rayon analogue,
// strsim.rs:72-105). threads <= 0 -> hardware concurrency.
void strsim_compute_mt(int32_t measure, const int32_t* codes_a,
                       const int64_t* off_a, const int32_t* codes_b,
                       const int64_t* off_b, const uint8_t* validity,
                       int64_t n, int32_t threads, double* out) {
  int64_t t = threads > 0 ? threads : (int64_t)std::thread::hardware_concurrency();
  if (t <= 1 || n < 4096) {
    compute_range(measure, codes_a, off_a, codes_b, off_b, validity, 0, n, out);
    return;
  }
  t = std::min<int64_t>(t, n);
  std::vector<std::thread> pool;
  pool.reserve(t);
  int64_t chunk = n / t;
  for (int64_t i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = (i == t - 1) ? n : lo + chunk;
    pool.emplace_back(compute_range, measure, codes_a, off_a, codes_b, off_b,
                      validity, lo, hi, out);
  }
  for (auto& th : pool) th.join();
}

namespace {

// Host finalization (integer stats -> exact f64 scores) fused with the
// scatter back to original row order. Each case mirrors ops/finalize.py
// FORMULA-FOR-FORMULA in the reference's evaluation order (left-to-right,
// same associativity — strsim.rs:160, 241-242, 267, 301-306, 343), so the
// scores are bit-identical to the numpy finalizers (locked by
// tests/test_torch_native.py). Scalar IEEE
// doubles on SSE2: no extended precision, same rounding as numpy's
// elementwise loops. s0/s1/s2 are the measure's stat fields in
// binding.FINALIZE_FIELDS order; sel (optional) holds scatter indices.
void finalize_range(int32_t measure, const int32_t* s0, const int32_t* s1,
                    const int32_t* s2, const int32_t* la, const int32_t* lb,
                    const int64_t* sel, int64_t lo, int64_t hi, double* out) {
  for (int64_t i = lo; i < hi; ++i) {
    int64_t A = la[i], B = lb[i];
    bool both_empty = (A == 0) && (B == 0);
    bool any_empty = (A == 0) || (B == 0);
    double sim = 0.0;
    switch (measure) {
      case 0:    // levenshtein: 1 - d/max (strsim.rs:160)
      case 12: { // osa: same formula + guards over osa_d
        int64_t maxlen = std::max(A, B);
        int64_t d = any_empty ? maxlen : (int64_t)s0[i];
        sim = 1.0 - ((double)d / (double)std::max<int64_t>(maxlen, 1));
        if (both_empty) sim = 1.0;
        break;
      }
      case 1:   // jaro (strsim.rs:241-242)
      case 2: { // jaro_winkler (strsim.rs:267)
        int64_t m = s0[i];
        int64_t t = s1[i];
        double mf = (double)m;
        double js = (mf / (double)std::max<int64_t>(A, 1) +
                     mf / (double)std::max<int64_t>(B, 1) +
                     (double)(m - t / 2) / (double)std::max<int64_t>(m, 1)) /
                    3.0;
        if (m == 0) js = 0.0;
        if (both_empty) js = 1.0;
        sim = js;
        if (measure == 2) {
          double prefix = (double)s2[i];
          double boosted = js + ((prefix * 0.1) * (1.0 - js));
          sim = (js > 0.7) ? boosted : js;
        }
        break;
      }
      case 3: {  // jaccard: inter / (la + lb - inter) (strsim.rs:301-306)
        int64_t inter = s0[i];
        int64_t den = A + B - inter;
        sim = (double)inter / (double)std::max<int64_t>(den, 1);
        if (any_empty) sim = 0.0;
        if (both_empty) sim = 1.0;
        break;
      }
      case 4: {  // sorensen_dice: 2*inter / (la + lb) (strsim.rs:343)
        int64_t inter = s0[i];
        sim = (2.0 * (double)inter) / (double)std::max<int64_t>(A + B, 1);
        if (any_empty) sim = 0.0;
        if (both_empty) sim = 1.0;
        break;
      }
      case 5:   // jaccard_bigram (extension; eq stat patches equal rows)
      case 6: { // sorensen_dice_bigram
        int64_t na = std::max<int64_t>(A - 1, 0);
        int64_t nb = std::max<int64_t>(B - 1, 0);
        int64_t inter = s0[i];
        if (measure == 5) {
          int64_t den = na + nb - inter;
          sim = (double)inter / (double)std::max<int64_t>(den, 1);
        } else {
          sim = (2.0 * (double)inter) / (double)std::max<int64_t>(na + nb, 1);
        }
        if (na == 0 || nb == 0) sim = 0.0;
        if (s1[i]) sim = 1.0;  // row-equality patch (ops/finalize.py:84-91)
        break;
      }
      case 7: {  // cosine: inter / sqrt(la*lb) (extension)
        int64_t inter = s0[i];
        double den = std::sqrt((double)(A * B));
        sim = (double)inter / std::max(den, 1.0);
        if (any_empty) sim = 0.0;
        if (both_empty) sim = 1.0;
        break;
      }
      case 8: {  // overlap: inter / min(la, lb) (extension)
        int64_t inter = s0[i];
        sim = (double)inter / (double)std::max<int64_t>(std::min(A, B), 1);
        if (any_empty) sim = 0.0;
        if (both_empty) sim = 1.0;
        break;
      }
      case 9: {  // hamming: matches / max(la, lb) (extension)
        sim = (double)(int64_t)s0[i] /
              (double)std::max<int64_t>(std::max(A, B), 1);
        if (both_empty) sim = 1.0;
        break;
      }
      case 10: {  // lcs_seq: lcs / max(la, lb) (extension)
        sim = (double)(int64_t)s0[i] /
              (double)std::max<int64_t>(std::max(A, B), 1);
        if (any_empty) sim = 0.0;
        if (both_empty) sim = 1.0;
        break;
      }
      case 11: {  // indel: 2*lcs / (la + lb) (extension)
        sim = (2.0 * (double)s0[i]) / (double)std::max<int64_t>(A + B, 1);
        if (any_empty) sim = 0.0;
        if (both_empty) sim = 1.0;
        break;
      }
      case 13: {  // soundex: 0/1 code equality (extension)
        sim = (double)s0[i];
        if (any_empty) sim = 0.0;
        if (both_empty) sim = 1.0;
        break;
      }
      default:
        sim = -1.0;
    }
    out[sel ? sel[i] : i] = sim;
  }
}

}  // namespace

// Finalize + scatter, threaded. s1/s2 may be null for measures that use
// fewer stat fields; sel may be null (identity scatter).
void strsim_finalize_scatter(int32_t measure, const int32_t* s0,
                             const int32_t* s1, const int32_t* s2,
                             const int32_t* la, const int32_t* lb,
                             const int64_t* sel, int64_t n, double* out) {
  int64_t t =
      std::min<int64_t>((int64_t)std::thread::hardware_concurrency(), 8);
  if (n < 65536 || t <= 1) {
    finalize_range(measure, s0, s1, s2, la, lb, sel, 0, n, out);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(t);
  int64_t chunk = n / t;
  for (int64_t i = 0; i < t; ++i) {
    int64_t lo = i * chunk;
    int64_t hi = (i == t - 1) ? n : lo + chunk;
    pool.emplace_back(finalize_range, measure, s0, s1, s2, la, lb, sel, lo,
                      hi, out);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
