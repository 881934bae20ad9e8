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
// query and candidate once. Most pairs of a name dictionary cannot enter a
// query's top k, so the design spends the greedy on few pairs:
//   * a thread a query, the queries ordered by length (a warp's lanes take
//     about the same number of greedy steps), the top k of its query in its
//     registers;
//   * the screen: each lane bounds m of its query against each candidate of
//     a chunk of kChunk from words alone (every matched a-char occurs in b
//     and every matched b-char in a, so m <= la - #{i: a_i not in b} and
//     m <= lb - #{j: b_j not in a}), from two bit-planes of each string's
//     per-bucket char counts (bucket x: the chars whose alphabet index is x
//     mod 32; a count saturates at 3, which only lowers what is taken off,
//     as the folding mod 32 does, so the bound stays above m) and their
//     union, the presence word; it drops the pair where the float32 bound
//     on the best score the pair could reach (t = 0, the winkler boost
//     taken always, kMargin over float32's rounding) is below the lane's
//     k-th score; a stale, lower k-th only keeps more; it keeps about 1
//     pair in 5 of a name dictionary's (the greedy share, PERF.md), and it
//     pays even where most pairs survive it, so every chunk is screened;
//   * the compaction: the chunk's survivors (owner lane, candidate) go into
//     the warp's queue in shared memory, each lane's in candidate order
//     after the lanes below it, and each time the queue holds a warp's
//     worth, every lane runs the greedy for one of them: its owner's chars
//     from qbuf, the candidate's equality table (a word for each alphabet
//     index, the bits of its positions holding that char, built in shared
//     memory once a tile; chars no candidate has map to index na, whose
//     word is 0), four positions' words read ahead of their chain, the
//     window moved by one shift-add a step; then the same bound on the real
//     m against the owner's k-th, and for what is left t and the float64
//     finish; the scores that could enter go back to their owners through
//     shared memory, every owner at once. A tile's end drains the rest;
//   * a pair enters a top k only above its k-th by (score descending,
//     candidate index ascending), so the order in which the queue hands
//     pairs back does not matter: that order is the tie rule.
// Chars are compared as alphabet indices, exact for every codepoint on int8
// and int32 tiles. Rows longer than kTopkMaxLen and alphabets larger than
// kTopkMaxAlphabet take the plain torch route (ops/topk_cuda.py:topk_plain).
// A nullable counter receives the pairs that ran the greedy, one atomic add
// a warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kTopkThreads = 640;      // threads (queries) a block, at most: 96 registers, no spill
constexpr int kTopkMaxLen = 32;        // longest query or candidate: one 32-bit word
constexpr int kTopkSlots = 8;          // the largest k
constexpr int kTopkMaxAlphabet = 253;  // indices 0..252, absent 253 (also past a query), pad 0xFE
constexpr int kTopkMaxTile = 2048;     // a queue entry's candidate field: 11 bits
constexpr int kTopkMaxDevices = 64;
constexpr int kTopkSmemMax = 232448;   // an H100 block's shared memory, opted in
constexpr int kQuot = kTopkMaxLen + 1;
constexpr int kChunk = 8;              // candidates a warp screens between two compactions
constexpr int kQueue = kWarp * (kChunk + 1);  // entries a warp's queue holds: 31 left + a chunk
// a warp's own shared memory: a drain's scores and candidates, its queue
constexpr int kWarpBytes = kWarp * 8 + kWarp * 4 + kQueue * 2;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// The block's shared memory: the quotient table, the alphabet, 1 / 3l for
// every length, each thread's query indices (word w of thread x at w *
// threads + x, four indices a word), each warp's drain results and queue,
// then the tile: its candidates' tables (na + 1 words each), screen
// words (two count planes, first four indices, length; kChunk - 1 more of
// zeros past the tile's last) and indices (32 bytes each).
struct TopkLayout {
  int alpha, rl3, qbuf, warps, tab, scr, cidx, bytes;
  __host__ __device__ TopkLayout(int na, int tile, int threads) {
    alpha = align16(kQuot * kQuot * 8);
    rl3 = alpha + align16(na * 4);
    qbuf = rl3 + align16(kQuot * 4);
    warps = qbuf + kTopkMaxLen * threads;
    tab = warps + align16(threads / kWarp * kWarpBytes);
    scr = tab + align16(tile * (na + 1) * 4);
    cidx = scr + (tile + kChunk - 1) * 16;
    bytes = cidx + tile * kTopkMaxLen;
  }
};

// The most candidates a tile holds at this alphabet and block size.
__host__ __device__ inline int topk_max_tile(int na, int threads) {
  const int fixed = TopkLayout(na, 0, threads).bytes + 16;
  const int per = (na + 1) * 4 + 16 + kTopkMaxLen;
  const int most = (kTopkSmemMax - fixed) / per;
  return most < kTopkMaxTile ? most : kTopkMaxTile;
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

// One more char of alphabet index x in a string's count planes (bit x mod
// 32 of p0, p1: its bucket's count, saturating at 3).
__device__ __forceinline__ void count_char(uint32_t& p0, uint32_t& p1, uint32_t x) {
  const uint32_t bit = 1u << (x & 31u);
  const uint32_t full = p0 & p1 & bit;
  p1 |= p0 & bit;
  p0 ^= bit & ~full;
}

// An upper bound of the chars of a string (length l, count planes p0, p1)
// whose bucket occurs in the other string (presence word other).
__device__ __forceinline__ int present_chars(int l, uint32_t p0, uint32_t p1, uint32_t other) {
  return l - __popc(p0 & ~other) - 2 * __popc(p1 & ~other);
}

// (v, c) ranks above (w, d): the higher score, or the lower candidate index
// at equal scores
__device__ __forceinline__ bool ranks_above(double v, int c, double w, int d) {
  return v > w || (v == w && c < d);
}

constexpr float kMargin = 1e-4f;  // over float32's rounding in score_bound and the k-th

// A float32 bound, above the float64 score, of a pair with m matches and no
// transposition (the winkler boost taken whatever jaro is), from 1 / 3la
// and 1 / 3lb.
template <bool kWinkler>
__device__ __forceinline__ float score_bound(int m, float ra3, float rb3, int prefix) {
  float x = __fmaf_rn((float)m, ra3 + rb3, 1.0f / 3.0f);
  if constexpr (kWinkler) x = __fmaf_rn(0.1f * (float)prefix, 1.0f - x, x);
  return x;
}

// The common prefix, capped at 4, of two strings' first four indices (the
// pads differ per side), from their xor: its trailing zero bytes.
__device__ __forceinline__ int head_prefix(uint32_t diff) { return __clz(__brev(diff)) >> 3; }

template <typename T, bool kWinkler>
__global__ void __launch_bounds__(kTopkThreads, 1)
    topk_kernel(const T* __restrict__ q_codes, long long q_stride, const int* __restrict__ q_len,
                const long long* __restrict__ q_rows, int nq, const uint8_t* __restrict__ c_idx,
                const int* __restrict__ c_len, const int* __restrict__ c_ids, int nc,
                const int* __restrict__ alphabet, int na, int tile, int k,
                long long* __restrict__ out_idx, double* __restrict__ out_score,
                unsigned long long* __restrict__ greedy_pairs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & (kWarp - 1);
  const TopkLayout lay(na, tile, nt);
  double* quot = reinterpret_cast<double*>(smem);
  int* alpha = reinterpret_cast<int*>(smem + lay.alpha);
  uint32_t* qbuf = reinterpret_cast<uint32_t*>(smem + lay.qbuf);
  unsigned char* own = smem + lay.warps + (tid / kWarp) * kWarpBytes;
  double* res_v = reinterpret_cast<double*>(own);                    // a drain's scores
  uint32_t* res_c = reinterpret_cast<uint32_t*>(own + kWarp * 8);    // their candidates
  uint16_t* queue = reinterpret_cast<uint16_t*>(own + kWarp * 12);  // owner << 11 | candidate
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + lay.tab);
  uint4* scr = reinterpret_cast<uint4*>(smem + lay.scr);
  uint8_t* cidx = smem + lay.cidx;
  float* rl3 = reinterpret_cast<float*>(smem + lay.rl3);  // 1 / (3 max(l, 1))
  const int a1 = na + 1;

  for (int e = tid; e < kQuot * kQuot; e += nt) {
    const int num = e / kQuot, den = e % kQuot;
    quot[e] = den ? __ddiv_rn((double)num, (double)den) : 0.0;
  }
  for (int e = tid; e < na; e += nt) alpha[e] = alphabet[e];
  for (int e = tid; e < kQuot; e += nt) rl3[e] = 1.0f / (float)(3 * max(e, 1));
  __syncthreads();

  // this thread's query: its chars as alphabet indices in qbuf, its first
  // word, presence word and count planes in registers
  const long long r = (long long)blockIdx.x * nt + tid;
  const bool live = r < nq;
  const long long row = live ? q_rows[r] : 0;
  const int la = live ? q_len[row] : 0;
  uint32_t q0 = 0u, qp0 = 0u, qp1 = 0u;
  for (int w = 0; w < kTopkMaxLen / 4; ++w) {
    uint32_t word = 0u;
    for (int b = 0; b < 4; ++b) {
      const int i = 4 * w + b;
      uint32_t x = (uint32_t)na;  // past its length the absent index, whose table word is 0
      if (i < la) {
        x = (uint32_t)dense_index(alpha, na, (int)q_codes[row * q_stride + i]);
        count_char(qp0, qp1, x);
      }
      word |= x << (8 * b);
    }
    qbuf[w * nt + tid] = word;
    if (w == 0) q0 = word;
  }
  const uint32_t qpres = qp0 | qp1;
  const float ra3 = 1.0f / (float)(3 * max(la, 1));
  // the owner's word w of a queue entry's query at oq[w * nt]
  const uint32_t* const warp_q = qbuf + (tid - lane);

  double best[kTopkSlots];
  int bi[kTopkSlots];
#pragma unroll
  for (int s = 0; s < kTopkSlots; ++s) {
    best[s] = -1.0;
    bi[s] = -1;
  }
  double kth = -1.0;  // (best[k - 1], bi[k - 1]): a pair enters only above it
  int kidx = -1;
  float kthf = -1.0f;
  float cut = -2.0f;  // kthf less kMargin: a pair whose bound is below it cannot enter
  const auto consider = [&](double v, int c) {
    if (!ranks_above(v, c, kth, kidx)) return;
#pragma unroll
    for (int s = kTopkSlots - 1; s > 0; --s) {
      if (s >= k) continue;
      const bool up = ranks_above(v, c, best[s - 1], bi[s - 1]);
      const bool here = !up && ranks_above(v, c, best[s], bi[s]);
      best[s] = up ? best[s - 1] : (here ? v : best[s]);
      bi[s] = up ? bi[s - 1] : (here ? c : bi[s]);
    }
    if (ranks_above(v, c, best[0], bi[0])) {
      best[0] = v;
      bi[0] = c;
    }
    double x = best[0];
    int xi = bi[0];
#pragma unroll
    for (int s = 1; s < kTopkSlots; ++s) {
      x = s == k - 1 ? best[s] : x;
      xi = s == k - 1 ? bi[s] : xi;
    }
    kth = x;
    kidx = xi;
    kthf = (float)x;
    cut = kthf - kMargin;
  };

  const bool warp_live = __any_sync(kFull, live);
  unsigned greedy = 0u;  // pairs this lane ran the greedy for
  for (int c0 = 0; c0 < nc; c0 += tile) {
    const int n = min(tile, nc - c0);
    __syncthreads();  // the previous tile's last reads are done
    const uint4* src = reinterpret_cast<const uint4*>(c_idx + (long long)c0 * kTopkMaxLen);
    uint4* dst = reinterpret_cast<uint4*>(cidx);
    for (int e = tid; e < n * (kTopkMaxLen / 16); e += nt) dst[e] = src[e];
    for (int e = tid; e < n * a1; e += nt) tab[e] = 0u;
    for (int e = tid; e < kChunk - 1; e += nt) scr[n + e] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
    for (int c = tid; c < n; c += nt) {  // a candidate's table and screen words, by one thread
      uint32_t* t = tab + c * a1;
      const uint8_t* s = cidx + c * kTopkMaxLen;
      const int l = c_len[c0 + c];
      uint32_t p0 = 0u, p1 = 0u;
      for (int j = 0; j < l; ++j) {
        t[s[j]] |= 1u << j;
        count_char(p0, p1, s[j]);
      }
      scr[c] = make_uint4(p0, p1, *reinterpret_cast<const uint32_t*>(s), (uint32_t)l);
    }
    __syncthreads();
    if (!warp_live) continue;

    // One queue entry a lane (lane < cnt) from queue[from ...]: its greedy,
    // bound, t and finish; the scores that could enter go to their owners
    // through res_v and res_c.
    const auto drain = [&](int from, int cnt) {
      const bool has = lane < cnt;
      const uint32_t e = has ? queue[from + lane] : 0u;
      __syncwarp();  // read before the next chunk writes over it; the last results read
      const int owner = (int)(e >> 11), c = (int)(e & (kTopkMaxTile - 1));
      // the owner's length and k-th score in float32 (rounded to nearest, so
      // a score at or above the k-th is not below it)
      const unsigned long long lk =
          __shfl_sync(kFull, (unsigned long long)__float_as_uint(kthf) << 32 | (unsigned)la, owner);
      const int ola = (int)(unsigned)lk;
      const float okthf = __uint_as_float((unsigned)(lk >> 32));
      double v = 0.0;
      bool send = false;
      const uint4 w = scr[c];  // count planes, first four indices, length
      if (has) {
        const int lb = (int)w.w;
        if (ola == 0 || lb == 0) {  // strsim.rs:128-130: both empty 1.0, one empty 0.0
          v = ola == lb ? 1.0 : 0.0;
        } else {
          ++greedy;
          // the greedy match: a_i flags the first unflagged b_j == a_i with
          // |i - j| <= bound, for i < min(la, lb + bound)
          const uint32_t* oq = warp_q + owner;
          const uint32_t* tc = tab + c * a1;
          const uint32_t q0w = oq[0];
          const uint32_t diff = q0w ^ w.z;
          const int prefix = head_prefix(diff);
          const int bound = max(ola, lb) / 2 - 1;
          const int i_end = min(ola, lb + bound);
          // win: the b-positions in a_i's window, |i - j| <= bound
          uint32_t flag = 0u, mat = 0u, win = low_bits(bound + 1);
          // four a-positions a step of the loop, the next four's equality
          // words read (past the query's length: the absent index's 0)
          // before this four's chain
          uint32_t next[4], qv[kTopkMaxLen / 4];  // qv: the owner's words, for t
          qv[0] = q0w;
#pragma unroll
          for (int b = 0; b < 4; ++b) next[b] = tc[(q0w >> (8 * b)) & 0xFFu];
#pragma unroll
          for (int g = 0; g < kTopkMaxLen / 4; ++g) {
            if (4 * g >= i_end) break;
            uint32_t eq[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) eq[b] = next[b];
            if (g + 1 < kTopkMaxLen / 4) {
              qv[g + 1] = oq[(g + 1) * nt];
#pragma unroll
              for (int b = 0; b < 4; ++b) next[b] = tc[(qv[g + 1] >> (8 * b)) & 0xFFu];
            }
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int i = 4 * g + b;
              if (i >= i_end) break;
              const uint32_t cand = eq[b] & win & ~flag;
              flag |= cand & (0u - cand);
              mat |= cand ? 1u << i : 0u;
              win = win * 2u + (i < bound ? 1u : 0u);
            }
          }
          int m = __popc(flag);
          if (ola == 1 && lb == 1) m = (diff & 0xFFu) == 0u ? 1 : 0;  // strsim.rs:197-199
          if (m == 0) {
            v = 0.0;
          } else if (score_bound<kWinkler>(m, rl3[ola], rl3[lb], prefix) + kMargin < okthf) {
            v = -1.0;  // below the k-th: not sent
          } else {
            // t: the ranks where the r-th matched a char and the r-th flagged b char differ
            int t = 0;
            if (m >= 2) {
              const uint8_t* cs = cidx + c * kTopkMaxLen;
              uint32_t fb = flag;
#pragma unroll
              for (int g = 0; g < kTopkMaxLen / 4; ++g) {
                if (4 * g >= i_end) break;
#pragma unroll
                for (int b = 0; b < 4; ++b) {
                  if (mat >> (4 * g + b) & 1u) {
                    t += ((qv[g] >> (8 * b)) & 0xFFu) != cs[__ffs(fb) - 1] ? 1 : 0;
                    fb &= fb - 1u;
                  }
                }
              }
            }
            // ops/finalize.py: (m/la + m/lb + (m - t//2)/m) / 3.0, then
            // jaro + ((prefix * 0.1) * (1.0 - jaro)) where jaro > 0.7
            v = __ddiv_rn(__dadd_rn(__dadd_rn(quot[m * kQuot + ola], quot[m * kQuot + lb]),
                                    quot[(m - t / 2) * kQuot + m]),
                          3.0);
            if constexpr (kWinkler) {
              if (v > 0.7)
                v = __dadd_rn(v, __dmul_rn(__dmul_rn((double)prefix, 0.1), __dadd_rn(1.0, -v)));
            }
          }
        }
        send = (float)v >= okthf;
      }
      if (send) {
        res_v[lane] = v;
        res_c[lane] = (uint32_t)c;
      }
      __syncwarp();
      const uint32_t sent = __ballot_sync(kFull, send);
      if (sent) {  // each owner takes the lanes whose owner bits are its lane's, all at once
        uint32_t mine = sent;
#pragma unroll
        for (int b = 0; b < 5; ++b) {
          const uint32_t ones = __ballot_sync(kFull, send && (owner >> b & 1));
          mine &= (lane >> b & 1) ? ones : ~ones;
        }
        for (; mine; mine &= mine - 1u) {
          const int at = __ffs(mine) - 1;
          consider(res_v[at], c0 + (int)res_c[at]);
        }
      }
    };

    int queued = 0;  // entries in the warp's queue, the same in every lane
    for (int j0 = 0;; j0 += kChunk) {
      const int jn = min(kChunk, n - j0);
      // bit j: candidate j0 + j goes to the queue; a lane without a query
      // or with an empty one (both empty score 1.0) keeps every pair
      uint32_t pass = ~0u;
      if (la > 0) {
        const uint4* sw = scr + j0;  // count planes, first four indices, length
        pass = 0u;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const uint4 w = sw[j];
          const int lb = (int)w.w;
          const int m = min(present_chars(la, qp0, qp1, w.x | w.y), present_chars(lb, w.x, w.y, qpres));
          const float most = score_bound<kWinkler>(m, ra3, rl3[lb], head_prefix(q0 ^ w.z));
          pass |= most < cut ? 0u : 1u << j;
        }
      }
      pass &= live ? low_bits(jn) : 0u;
      // the survivors to the queue, lane by lane, each lane's in candidate order
      const int mine = __popc(pass);
      int upto = mine;  // this lane's and the lanes' below
      for (int d = 1; d < kWarp; d <<= 1) {
        const int y = __shfl_up_sync(kFull, upto, d);
        if (lane >= d) upto += y;
      }
      const int total = __shfl_sync(kFull, upto, kWarp - 1);
      int at = queued + upto - mine;
      for (uint32_t p = pass; p; p &= p - 1u)
        queue[at++] = (uint16_t)(lane << 11 | (j0 + __ffs(p) - 1));
      queued += total;
      __syncwarp();
      const bool last = j0 + kChunk >= n;
      while (queued >= kWarp || (last && queued > 0)) {
        const int cnt = min(queued, kWarp);
        queued -= cnt;
        drain(queued, cnt);
      }
      if (last) break;
    }
  }

  if (greedy_pairs != nullptr && warp_live) {
    const unsigned warp_greedy = __reduce_add_sync(kFull, greedy);
    if (lane == 0) atomicAdd(greedy_pairs, (unsigned long long)warp_greedy);
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
  unsigned long long* greedy_pairs;
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
        alphabet, na, tile, k, out_idx, out_score, greedy_pairs);
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
// the block's (0: the default); greedy_pairs: an int64 on the device that
// the pairs which ran the greedy are added to, or null. Returns the
// launch's cudaError_t.
extern "C" int strsim_topk_scan(const void* q_codes, long long q_stride, const void* q_len,
                                const void* q_rows, int nq, const void* c_idx, const void* c_len,
                                const void* c_ids, int nc, const void* alphabet, int na, int tile,
                                int k, int winkler, int threads, void* out_idx, void* out_score,
                                void* greedy_pairs, int elem_bytes, void* stream) {
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
                   static_cast<unsigned long long*>(greedy_pairs), static_cast<cudaStream_t>(stream)};
  if (elem_bytes == 1) return (int)(winkler ? f.run<int8_t, true>() : f.run<int8_t, false>());
  if (elem_bytes == 4) return (int)(winkler ? f.run<int32_t, true>() : f.run<int32_t, false>());
  return (int)cudaErrorInvalidValue;
}
