// A group of G lanes per row pair, for the bit-parallel kernels that run one
// step per char over a row's 32-bit words: the scan kernel of dp_scan.cuh
// (K1, K6, K7) and the jaro scan of jaro_scan.cu (K2).
//
// G is the row's word count rounded up to a power of two (1, 2, 4, 8, 16),
// so a warp serves 32 / G rows and lane w of a group owns word w (bits
// 32w .. 32w + 31) of every state vector. Spare high lanes hold words with no
// equality bits: carries and shift-outs only run upwards, so they never reach
// a word below. What crosses lanes:
//   * the addition carry, by carry-lookahead on two ballots (generate,
//     propagate), as ops/bitwords.py:add does on tensors;
//   * the shift-ins of a left shift, from lane w - 1 by __shfl_up_sync (lane
//     0 takes the fill);
//   * sums over the group (LCS popcounts, transposition counts), by
//     __shfl_xor_sync.
// G = 1 is the same code with no traffic between lanes.
//
// Each warp owns one slice of the block's dynamic shared memory: on int8
// tiles an equality table `peq[c * 32 + lane of the warp]`, c in 0..127 (16
// KB), of which every lane reads and writes its own column only, then the
// warp's rows of the tile, staged once with coalesced loads.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bitdp.cuh"

namespace strsim {
namespace {

constexpr int kWarp = 32;
constexpr int kAscii = 128;                           // int8 table rows: codes 0..127
constexpr int kTableBytes = kAscii * kWarp * 4;       // one warp's equality table
constexpr int kStageSlack = 16;                       // the alignment shift of a staged span

constexpr unsigned kFull = 0xFFFFFFFFu;

// A group's view of the warp. Every collective takes the whole warp (all 32
// lanes execute it together, every group at once): a warp whose groups each
// named their own lanes would run the groups' collectives one group after
// another. So a kernel keeps all lanes of a warp in step around them, its
// loops running to the warp's longest trip count with the finished groups'
// updates masked off.
template <int G>
struct LaneGroup {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8 || G == 16, "G: a power of two <= 16");
  int base;  // the group's first lane in the warp
  int lane;  // this lane's word

  __device__ __forceinline__ LaneGroup() {
    const int wl = threadIdx.x & (kWarp - 1);
    lane = wl & (G - 1);
    base = wl - lane;
  }

  // bit k: the predicate of the group's lane k
  __device__ __forceinline__ unsigned ballot(bool p) const {
    if constexpr (G == 1) return p ? 1u : 0u;
    else return (__ballot_sync(kFull, p) >> base) & ((1u << G) - 1u);
  }

  // v of lane - 1; lane 0 gets `fill`
  __device__ __forceinline__ uint32_t from_below(uint32_t v, uint32_t fill) const {
    if constexpr (G == 1) {
      return fill;
    } else {
      const uint32_t u = __shfl_up_sync(kFull, v, 1, G);
      return lane == 0 ? fill : u;
    }
  }

  __device__ __forceinline__ int sum(int v) const {
#pragma unroll
    for (int d = 1; d < G; d <<= 1) v += __shfl_xor_sync(kFull, v, d, G);
    return v;
  }

  // sum of v over the lanes below this one
  __device__ __forceinline__ int exclusive_sum(int v) const {
    int x = v;
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d, G);
      if (lane >= d) x += y;
    }
    return x - v;
  }

  // the largest v of the warp: the trip count every lane of it runs
  __device__ __forceinline__ int warp_max(int v) const {
    if constexpr (G == 1) return v;
    else return (int)__reduce_max_sync(kFull, (unsigned)max(v, 0));
  }

  __device__ __forceinline__ void sync() const {
    if constexpr (G > 1) __syncwarp(kFull);
  }
};

// (x + y) mod 2^(32 G) over the group's words, word `lane` here. The carry
// into word w is 1 when some word k < w generates (its sum overflows) and
// every word between propagates (its sum is all ones): the carries of the
// integer sum (gen | prop) + gen, over one bit a word. Never both at once:
// an overflowing sum of two words is at most 2^33 - 2.
template <int G>
__device__ __forceinline__ uint32_t group_add(const LaneGroup<G>& g, uint32_t x, uint32_t y) {
  const uint32_t s = x + y;
  if constexpr (G == 1) {
    return s;
  } else {
    const unsigned gen = g.ballot(s < x);
    const unsigned prop = g.ballot(s == 0xFFFFFFFFu);
    const unsigned a = gen | prop;
    return s + ((((a + gen) ^ a ^ gen) >> g.lane) & 1u);
  }
}

// --- the recurrences, one word a lane ------------------------------------
// The same steps as bitdp.cuh's per-word forms (myers_word, osa_word,
// lcs_word), with the carry record replaced by group_add and from_below.
// `tbit` is the tracked bit's mask on the lane that holds the pattern's last
// position, 0 on the others; the Myers and OSA steps return the score's
// change there (0 elsewhere).

template <int G>
__device__ __forceinline__ int myers_lane(const LaneGroup<G>& g, uint32_t e, uint32_t& pv,
                                          uint32_t& mv, uint32_t tbit) {
  const uint32_t p = pv, m = mv;
  const uint32_t xh = (group_add(g, e & p, p) ^ p) | e;
  const uint32_t xv = e | m;
  const uint32_t ph = m | ~(xh | p);
  const uint32_t mh = p & xh;
  const int delta = (int)((ph & tbit) != 0u) - (int)((mh & tbit) != 0u);
  const uint32_t in = g.from_below((ph >> 31) | ((mh >> 31) << 1), 1u);  // Ph fills 1, Mh 0
  const uint32_t ph_s = (ph << 1) | (in & 1u);
  const uint32_t mh_s = (mh << 1) | (in >> 1);
  pv = mh_s | ~(xv | ph_s);
  mv = ph_s & xv;
  return delta;
}

// Hyyro OSA in the D0 form: d0p and pmo hold the previous text char's D0 and
// Eq words (zero before the first); TR's shift takes bit 31 of word w - 1.
template <int G>
__device__ __forceinline__ int osa_lane(const LaneGroup<G>& g, uint32_t e, uint32_t& pv,
                                        uint32_t& mv, uint32_t& d0p, uint32_t& pmo,
                                        uint32_t tbit) {
  const uint32_t p = pv, m = mv;
  const uint32_t t = ~d0p & e;
  const uint32_t tr = ((t << 1) | g.from_below(t >> 31, 0u)) & pmo;
  const uint32_t d0 = (group_add(g, e & p, p) ^ p) | e | m | tr;
  const uint32_t hp = m | ~(d0 | p);
  const uint32_t hn = d0 & p;
  const int delta = (int)((hp & tbit) != 0u) - (int)((hn & tbit) != 0u);
  const uint32_t in = g.from_below((hp >> 31) | ((hn >> 31) << 1), 1u);  // HP fills 1, HN 0
  const uint32_t hp_s = (hp << 1) | (in & 1u);
  const uint32_t hn_s = (hn << 1) | (in >> 1);
  pv = hn_s | ~(d0 | hp_s);
  mv = hp_s & d0;
  d0p = d0;
  pmo = e;
  return delta;
}

// Allison-Dix LCS: U = V & Eq; V = (V + U) | (V ^ U)
template <int G>
__device__ __forceinline__ void lcs_lane(const LaneGroup<G>& g, uint32_t e, uint32_t& v) {
  const uint32_t x = v, u = x & e;
  v = group_add(g, x, u) | (x ^ u);
}

// --- equality words -------------------------------------------------------

__device__ __forceinline__ void clear_table(uint32_t* peq, int wl) {
  uint4* t4 = reinterpret_cast<uint4*>(peq);
  for (int k = wl; k < kTableBytes / 16; k += kWarp) t4[k] = make_uint4(0u, 0u, 0u, 0u);
}

// This lane's word of a row's equality vector for one char: bit k is
// (s[k] == ch) for the `count` chars s[0 .. count) of the lane's word.

// From the warp's table, filled here in this lane's column: row c & 127 holds
// the positions of the word whose char has those low seven bits, and `below`
// those whose char is below 0. An int8 char shares its low seven bits only
// with the char 128 away, of the other sign, so the row read for ch, kept to
// the positions of ch's sign, is exact for every int8 value (the encoder's
// codes are 0..127; the pads never lie inside a length).
struct TableEq {
  const uint32_t* col;
  uint32_t below;

  __device__ __forceinline__ TableEq(uint32_t* peq, int wl, const int8_t* s, int count)
      : col(peq + wl), below(0u) {
    for (int k = 0; k < count; ++k) {
      const int c = s[k];
      peq[(c & (kAscii - 1)) * kWarp + wl] |= 1u << k;
      below |= (uint32_t)(c < 0) << k;
    }
  }
  __device__ __forceinline__ uint32_t operator()(int8_t ch) const {
    return col[((int)ch & (kAscii - 1)) * kWarp] & (ch < 0 ? below : ~below);
  }
};

// By compares with the word's 32 chars, held in registers.
struct RegisterEq {
  int32_t c[32];
  uint32_t valid;

  __device__ __forceinline__ RegisterEq(uint32_t*, int, const int32_t* s, int count)
      : valid(low_bits(count)) {
#pragma unroll
    for (int k = 0; k < 32; ++k) c[k] = k < count ? s[k] : 0;
  }
  __device__ __forceinline__ uint32_t operator()(int32_t ch) const {
    uint32_t e = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) e |= (uint32_t)(c[k] == ch) << k;
    return e & valid;
  }
};

// The equality words a kernel reads on tiles of T: the table on int8 tiles;
// on int32 tiles, whose codepoints cannot index a table, compares.
template <typename T>
using LaneEq = std::conditional_t<sizeof(T) == 1, TableEq, RegisterEq>;

// --- staging ---------------------------------------------------------------

// Bytes of a warp's staging area for `rows` rows of 2L chars of T.
template <typename T>
__host__ __device__ constexpr int stage_bytes(int rows, int L) {
  return ((rows * 2 * L * (int)sizeof(T) + kStageSlack) + 15) & ~15;
}

// The warp copies its rows [r0, r0 + rows) of a and b into `stage` (16-byte
// aligned) and returns where row r0 begins there: row r0 + k holds a's L
// chars, then b's, at 2Lk elements from it. When the rows are one span of a
// packed [n, 2L] tile (b = a + L, both strides 2L) the span goes in one copy
// of 16-byte loads, shifted by the source's offset from a 16-byte boundary so
// that both sides align (rows at odd widths start anywhere); otherwise each
// row's a and b are copied char by char (any row stride >= L).
template <typename T>
__device__ __forceinline__ const T* stage_rows(unsigned char* stage, const T* a, const T* b,
                                               long long stride_a, long long stride_b,
                                               long long r0, int rows, int L, bool packed,
                                               int wl) {
  if (packed) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(a + r0 * stride_a);
    const int bytes = rows * 2 * L * (int)sizeof(T);
    const int mis = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    unsigned char* dst = stage + mis;
    const int head = min((16 - mis) & 15, bytes);
    const int body = (bytes - head) >> 4;
    for (int k = wl; k < head; k += kWarp) dst[k] = src[k];
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    for (int k = wl; k < body; k += kWarp) d4[k] = __ldg(s4 + k);
    for (int k = head + (body << 4) + wl; k < bytes; k += kWarp) dst[k] = src[k];
    return reinterpret_cast<const T*>(dst);
  }
  T* dst = reinterpret_cast<T*>(stage);
  for (int k = 0; k < rows; ++k) {
    const T* ar = a + (r0 + k) * stride_a;
    const T* br = b + (r0 + k) * stride_b;
    T* row = dst + 2LL * L * k;
    for (int e = wl; e < L; e += kWarp) {
      row[e] = ar[e];
      row[L + e] = br[e];
    }
  }
  return dst;
}

// G for a width: its word count rounded up to a power of two
__host__ __device__ constexpr int group_lanes(int words) {
  return words <= 1 ? 1 : words <= 2 ? 2 : words <= 4 ? 4 : words <= 8 ? 8 : 16;
}

}  // namespace
}  // namespace strsim
