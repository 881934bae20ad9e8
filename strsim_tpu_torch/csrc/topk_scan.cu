// K23: the running top-k of jaro or jaro_winkler over a query column against
// a candidate column, Q x C pairs, exact float64 scores on the device.
//
// Replaces, on the linkage path, strsim_tpu/ops/jaro_pallas_scan.py:_kernel
// (:106, its pallas_call :382), which strsim_tpu/models/linkage.py:
// _scan_scorer runs inside its lax.scan over candidate blocks (each block's
// pairs materialised by jnp.repeat/jnp.tile, scored by
// ops/finalize_device.py in float32, merged by lax.top_k). Here the pairs
// are never materialised: each thread holds one query, the block sweeps the
// candidates through shared memory in tiles, and only [Q, k] leaves the
// card; the greedy scan, the transpositions, the prefix, the finish and the
// merge are all in this kernel.
//
// Contract (ops/topk_cuda.py, models/linkage.py): queries are rows q_rows[r]
// of q_codes (int8 or int32, stride q_stride), their lengths q_len[row] <=
// kTopkMaxLen; candidates are the nc rows of c_idx, each one's chars given as
// indices into the sorted alphabet of all candidate chars (0..na-1, pad
// kCandPad past c_len), in index order. For every query, the k <= kTopkSlots
// candidates of highest score, by (score descending, candidate index
// ascending), go to out_idx[row, s] (as c_ids[candidate]) and
// out_score[row, s]; slots with no candidate are left as the caller filled
// them. A pair's score is polars-strsim's (strsim.rs:128-271): both empty
// 1.0, one side empty 0.0, else jaro from the greedy windowed match (m) and
// its transpositions (t), finished as ops/finalize.py:finalize_jaro and, for
// jaro_winkler, finalize_jaro_winkler do on the host, in their order of
// operations, by __dadd_rn / __dmul_rn / __ddiv_rn (no contraction into an
// FMA), so each score has the host's bits. m / l for every m, l <= 32 comes
// from a table of quotients each block builds with __ddiv_rn.
//
// What bounds it on this card: integer operations (the greedy's dependent
// step per a-position, its equality read and window), about 55 a pair at
// least (perfbench/roofline/_counts.py), not memory: a call reads each
// query and candidate once. The design, against that:
//   * a thread a query, the queries ordered by length, so a warp's lanes run
//     the same number of greedy steps; every lane of a warp reads the same
//     candidate at once (a shared-memory broadcast);
//   * the equality word of a_i is one shared-memory read: each candidate's
//     table, a word for each char of the alphabet (the bits of its positions
//     holding that char), is built in shared memory once a tile; a query's
//     chars are mapped to alphabet indices once, held four to a register;
//     chars no candidate has map to index na, whose word is 0;
//   * the window's upper edge moves by one shift-add a step, its lower edge
//     is one funnel shift;
//   * a bound in float32 on the best score a pair could reach (t = 0, the
//     winkler boost taken always) skips the greedy, the transpositions and
//     the float64 finish of a pair that cannot enter the query's top k; the
//     bound keeps a margin of 1e-4 over float32's rounding, so no pair that
//     could enter is skipped;
//   * the top k live in registers, sorted; a pair enters only above the
//     k-th score, so a later candidate of equal score never displaces an
//     earlier one: candidates arrive in index order, which is the tie rule.
// Chars are compared as alphabet indices, exact for every codepoint on int8
// and int32 tiles. Rows longer than kTopkMaxLen and alphabets larger than
// kTopkMaxAlphabet take the plain torch route (ops/topk_cuda.py:topk_plain).
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kTopkThreads = 1024;     // threads (queries) a block, at most
constexpr int kTopkMaxLen = 32;        // longest query or candidate: one 32-bit word
constexpr int kTopkSlots = 8;          // the largest k
constexpr int kTopkMaxAlphabet = 253;  // indices 0..252, absent 253, pads 0xFE / 0xFF
constexpr int kTopkMaxDevices = 64;
constexpr int kTopkSmemMax = 232448;   // an H100 block's shared memory, opted in
constexpr int kQuot = kTopkMaxLen + 1;
constexpr uint32_t kQueryPad = 0xFFu;  // past a query's length (kCandPad = 0xFE past a candidate's)

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// The block's shared memory: the quotient table, the alphabet, each
// thread's query indices (byte i of thread x at i * threads + x), then the
// tile: its candidates' tables (na + 1 words each), their indices (32 bytes
// each), lengths and reciprocal lengths.
struct TopkLayout {
  int alpha, qbuf, tab, cidx, clen, crl, bytes;
  __host__ __device__ TopkLayout(int na, int tile, int threads) {
    alpha = align16(kQuot * kQuot * 8);
    qbuf = alpha + align16(na * 4);
    tab = qbuf + kTopkMaxLen * threads;
    cidx = tab + align16(tile * (na + 1) * 4);
    clen = cidx + tile * kTopkMaxLen;
    crl = clen + tile * 4;
    bytes = crl + tile * 4;
  }
};

// The most candidates a tile holds at this alphabet and block size.
__host__ __device__ inline int topk_max_tile(int na, int threads) {
  const int fixed = TopkLayout(na, 0, threads).bytes + 16;
  const int per = (na + 1) * 4 + kTopkMaxLen + 8;
  return (kTopkSmemMax - fixed) / per;
}

// index of ch in the sorted alpha[0 .. na), or na where it is absent
__device__ __forceinline__ int dense_index(const int* alpha, int na, int ch) {
  int lo = 0, hi = na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (alpha[mid] < ch) lo = mid + 1;
    else hi = mid;
  }
  return lo < na && alpha[lo] == ch ? lo : na;
}

// A float32 bound, above the float64 score, of a pair with m matches and no
// transposition (the winkler boost taken whatever jaro is).
template <bool kWinkler>
__device__ __forceinline__ float score_bound(int m, float rla, float rlb, int prefix) {
  float x = ((float)m * rla + (float)m * rlb + 1.0f) * (1.0f / 3.0f);
  if constexpr (kWinkler) x += 0.1f * (float)prefix * (1.0f - x);
  return x;
}

template <typename T, bool kWinkler>
__global__ void __launch_bounds__(kTopkThreads, 1)
    topk_kernel(const T* __restrict__ q_codes, long long q_stride, const int* __restrict__ q_len,
                const long long* __restrict__ q_rows, int nq, const uint8_t* __restrict__ c_idx,
                const int* __restrict__ c_len, const int* __restrict__ c_ids, int nc,
                const int* __restrict__ alphabet, int na, int tile, int k,
                long long* __restrict__ out_idx, double* __restrict__ out_score) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  const TopkLayout lay(na, tile, nt);
  double* quot = reinterpret_cast<double*>(smem);
  int* alpha = reinterpret_cast<int*>(smem + lay.alpha);
  uint8_t* qbuf = smem + lay.qbuf;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + lay.tab);
  uint8_t* cidx = smem + lay.cidx;
  int* clen = reinterpret_cast<int*>(smem + lay.clen);
  float* crl = reinterpret_cast<float*>(smem + lay.crl);
  const int a1 = na + 1;

  for (int e = tid; e < kQuot * kQuot; e += nt) {
    const int num = e / kQuot, den = e % kQuot;
    quot[e] = den ? __ddiv_rn((double)num, (double)den) : 0.0;
  }
  for (int e = tid; e < na; e += nt) alpha[e] = alphabet[e];
  __syncthreads();

  // this thread's query, its chars as alphabet indices
  const long long r = (long long)blockIdx.x * nt + tid;
  const bool live = r < nq;
  const long long row = live ? q_rows[r] : 0;
  const int la = live ? q_len[row] : 0;
  for (int i = 0; i < kTopkMaxLen; ++i)
    qbuf[i * nt + tid] = (uint8_t)(i < la ? dense_index(alpha, na, (int)q_codes[row * q_stride + i])
                                          : kQueryPad);
  uint32_t qw[kTopkMaxLen / 4];
#pragma unroll
  for (int w = 0; w < kTopkMaxLen / 4; ++w) {
    qw[w] = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) qw[w] |= (uint32_t)qbuf[(4 * w + b) * nt + tid] << (8 * b);
  }
  const float rla = 1.0f / (float)max(la, 1);

  double best[kTopkSlots];
  int bi[kTopkSlots];
#pragma unroll
  for (int s = 0; s < kTopkSlots; ++s) {
    best[s] = -1.0;
    bi[s] = -1;
  }
  double kth = -1.0;  // best[k - 1]: a pair enters only above it
  float kthf = -1.0f;
  const auto consider = [&](double v, int c) {
    if (!(v > kth)) return;
#pragma unroll
    for (int s = kTopkSlots - 1; s > 0; --s) {
      const bool up = v > best[s - 1];
      const bool here = !up && v > best[s];
      best[s] = up ? best[s - 1] : (here ? v : best[s]);
      bi[s] = up ? bi[s - 1] : (here ? c : bi[s]);
    }
    if (v > best[0]) {
      best[0] = v;
      bi[0] = c;
    }
    double x = best[0];
#pragma unroll
    for (int s = 1; s < kTopkSlots; ++s) x = s == k - 1 ? best[s] : x;
    kth = x;
    kthf = (float)x;
  };

  for (int c0 = 0; c0 < nc; c0 += tile) {
    const int n = min(tile, nc - c0);
    __syncthreads();  // the previous tile's last reads are done
    const uint4* src = reinterpret_cast<const uint4*>(c_idx + (long long)c0 * kTopkMaxLen);
    uint4* dst = reinterpret_cast<uint4*>(cidx);
    for (int e = tid; e < n * (kTopkMaxLen / 16); e += nt) dst[e] = src[e];
    for (int c = tid; c < n; c += nt) {
      const int l = c_len[c0 + c];
      clen[c] = l;
      crl[c] = 1.0f / (float)max(l, 1);
    }
    for (int e = tid; e < n * a1; e += nt) tab[e] = 0u;
    __syncthreads();
    for (int c = tid; c < n; c += nt) {  // a candidate's table, by one thread
      uint32_t* t = tab + c * a1;
      const uint8_t* s = cidx + c * kTopkMaxLen;
      for (int j = 0; j < clen[c]; ++j) t[s[j]] |= 1u << j;
    }
    __syncthreads();
    if (!live) continue;

    for (int c = 0; c < n; ++c) {
      const int lb = clen[c];
      if (la == 0 || lb == 0) {  // strsim.rs:128-130: both empty 1.0, one empty 0.0
        consider(la == lb ? 1.0 : 0.0, c0 + c);
        continue;
      }
      const uint32_t chead = *reinterpret_cast<const uint32_t*>(cidx + c * kTopkMaxLen);
      const uint32_t diff = qw[0] ^ chead;  // the pads differ per side
      const int prefix = diff ? (__ffs(diff) - 1) >> 3 : 4;
      if (kth >= 0.0 && score_bound<kWinkler>(min(la, lb), rla, crl[c], prefix) + 1e-4f < kthf)
        continue;

      // the greedy match: a_i flags the first unflagged b_j == a_i with
      // |i - j| <= bound, for i < min(la, lb + bound)
      const int bound = max(la, lb) / 2 - 1;
      const int i_end = min(la, lb + bound);
      const uint32_t* tc = tab + c * a1;
      uint32_t flag = 0u, mat = 0u, hi = low_bits(bound + 1);  // hi: b-positions <= i + bound
#pragma unroll
      for (int i = 0; i < kTopkMaxLen; ++i) {
        if (i >= i_end) break;
        const uint32_t e = tc[(qw[i >> 2] >> (8 * (i & 3))) & 0xFFu];
        const uint32_t cand = e & hi & ones_from(i - bound) & ~flag;
        flag |= cand & (0u - cand);
        mat |= cand ? 1u << i : 0u;
        hi = hi * 2u + 1u;
      }
      int m = __popc(flag);
      if (la == 1 && lb == 1) m = (diff & 0xFFu) == 0u ? 1 : 0;  // strsim.rs:197-199
      if (m == 0) {
        consider(0.0, c0 + c);
        continue;
      }
      if (kth >= 0.0 && score_bound<kWinkler>(m, rla, crl[c], prefix) + 1e-4f < kthf) continue;

      // t: the ranks where the r-th matched a char and the r-th flagged b char differ
      int t = 0;
      if (m >= 2) {
        const uint8_t* cs = cidx + c * kTopkMaxLen;
        for (uint32_t ma = mat, fb = flag; fb; ma &= ma - 1u, fb &= fb - 1u)
          t += qbuf[(__ffs(ma) - 1) * nt + tid] != cs[__ffs(fb) - 1] ? 1 : 0;
      }
      // ops/finalize.py: (m/la + m/lb + (m - t//2)/m) / 3.0, then
      // jaro + ((prefix * 0.1) * (1.0 - jaro)) where jaro > 0.7
      double v = __ddiv_rn(__dadd_rn(__dadd_rn(quot[m * kQuot + la], quot[m * kQuot + lb]),
                                     quot[(m - t / 2) * kQuot + m]),
                           3.0);
      if constexpr (kWinkler) {
        if (v > 0.7)
          v = __dadd_rn(v, __dmul_rn(__dmul_rn((double)prefix, 0.1), __dadd_rn(1.0, -v)));
      }
      consider(v, c0 + c);
    }
  }

  if (!live) return;
#pragma unroll
  for (int s = 0; s < kTopkSlots; ++s) {
    if (s < k && bi[s] >= 0) {
      out_idx[row * k + s] = c_ids[bi[s]];
      out_score[row * k + s] = best[s];
    }
  }
}

struct TopkArgs {
  const void* q_codes;
  long long q_stride;
  const int* q_len;
  const long long* q_rows;
  int nq;
  const uint8_t* c_idx;
  const int *c_len, *c_ids;
  int nc;
  const int* alphabet;
  int na, tile, k, threads;
  long long* out_idx;
  double* out_score;
  cudaStream_t stream;

  template <typename T, bool kWinkler>
  cudaError_t run() const {
    const auto kernel = topk_kernel<T, kWinkler>;
    // the attribute belongs to a device's context: set once a device
    static std::atomic<bool> configured[kTopkMaxDevices];
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kTopkMaxDevices || !configured[device].load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTopkSmemMax);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
      if (device < kTopkMaxDevices) configured[device].store(true, std::memory_order_release);
    }
    const int smem = TopkLayout(na, tile, threads).bytes;
    kernel<<<(int)((nq + threads - 1) / threads), threads, smem, stream>>>(
        static_cast<const T*>(q_codes), q_stride, q_len, q_rows, nq, c_idx, c_len, c_ids, nc,
        alphabet, na, tile, k, out_idx, out_score);
    return cudaGetLastError();
  }
};

}  // namespace
}  // namespace strsim

// The most candidates one shared-memory tile holds for an alphabet of na
// chars and blocks of `threads` threads (0: the default).
extern "C" int strsim_topk_max_tile(int na, int threads) {
  using namespace strsim;
  return topk_max_tile(na, threads > 0 ? threads : kTopkThreads);
}

// One launch over the nq queries q_rows (int64 rows of q_codes, elem_bytes 1
// or 4, row stride q_stride; q_len int32 over all rows) against the nc
// candidates (c_idx [nc, 32] uint8, 16-byte aligned; c_len, c_ids int32),
// alphabet int32 [na] sorted; tile: the most candidates a tile (0: as many
// as shared memory holds); winkler: jaro_winkler (1) or jaro (0); threads:
// the block's (0: the default). Returns the launch's cudaError_t.
extern "C" int strsim_topk_scan(const void* q_codes, long long q_stride, const void* q_len,
                                const void* q_rows, int nq, const void* c_idx, const void* c_len,
                                const void* c_ids, int nc, const void* alphabet, int na, int tile,
                                int k, int winkler, int threads, void* out_idx, void* out_score,
                                int elem_bytes, void* stream) {
  using namespace strsim;
  if (threads == 0) threads = kTopkThreads;
  if (nq <= 0 || nc <= 0 || k < 1 || k > kTopkSlots || na < 0 || na > kTopkMaxAlphabet ||
      threads < kWarp || threads > kTopkThreads || threads % kWarp != 0 || tile < 0)
    return (int)cudaErrorInvalidValue;
  const int most = topk_max_tile(na, threads);
  tile = tile > 0 && tile < most ? tile : most;
  tile = tile < nc ? tile : nc;
  if (tile < 1) return (int)cudaErrorInvalidValue;
  const TopkArgs f{q_codes, q_stride, static_cast<const int*>(q_len),
                   static_cast<const long long*>(q_rows), nq, static_cast<const uint8_t*>(c_idx),
                   static_cast<const int*>(c_len), static_cast<const int*>(c_ids), nc,
                   static_cast<const int*>(alphabet), na, tile, k, threads,
                   static_cast<long long*>(out_idx), static_cast<double*>(out_score),
                   static_cast<cudaStream_t>(stream)};
  if (elem_bytes == 1) return (int)(winkler ? f.run<int8_t, true>() : f.run<int8_t, false>());
  if (elem_bytes == 4) return (int)(winkler ? f.run<int32_t, true>() : f.run<int32_t, false>());
  return (int)cudaErrorInvalidValue;
}
