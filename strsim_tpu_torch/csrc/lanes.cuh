// A group of G lanes per row pair, for the bit-parallel kernels that run one
// step per char over a row's 32-bit words: the scan kernel of dp_scan.cuh
// (K1, K6, K7), the jaro scan of jaro_scan.cu (K2), the fused lev/jaro kernel
// of lev_jaro_fused.cu (K5) and the bigram kernel of bigram.cu (K8).
//
// G is the row's word count rounded up to a power of two (1, 2, 4, 8, 16),
// so a warp serves 32 / G rows and lane w of a group owns word w (bits
// 32w .. 32w + 31) of every state vector. Spare high lanes hold words with no
// equality bits: carries and shift-outs only run upwards, so they never reach
// a word below. What crosses lanes:
//   * the addition carry, by carry-lookahead on two ballots (generate,
//     propagate), as ops/bitwords.py:add does on tensors;
//   * the shift-ins of a left shift, from lane w - 1 by __shfl_up_sync (lane
//     0 takes the fill), and of a right shift, from lane w + 1 by
//     __shfl_down_sync;
//   * the group's first set bit (the jaro flag, a consumed multiset bit), by
//     one ballot;
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

namespace strsim {
namespace {

constexpr int kWarp = 32;
constexpr int kAscii = 128;                           // int8 table rows: codes 0..127
constexpr int kTableBytes = kAscii * kWarp * 4;       // one warp's equality table
constexpr int kStageSlack = 16;                       // the alignment shift of a staged span

constexpr unsigned kFull = 0xFFFFFFFFu;

// bits [0, x) set, saturating at 0 and 32
__device__ __forceinline__ uint32_t low_bits(int x) {
  return x <= 0 ? 0u : (x >= 32 ? 0xFFFFFFFFu : (1u << x) - 1u);
}

// ~0 << s, s clamped to [0, 32]
__device__ __forceinline__ uint32_t ones_from(int s) {
  return __funnelshift_lc(0u, 0xFFFFFFFFu, (unsigned)max(s, 0));
}

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

  // v of lane + 1; the group's top lane gets `fill`
  __device__ __forceinline__ uint32_t from_above(uint32_t v, uint32_t fill) const {
    if constexpr (G == 1) {
      return fill;
    } else {
      const uint32_t u = __shfl_down_sync(kFull, v, 1, G);
      return lane == G - 1 ? fill : u;
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
// an overflowing sum of two words is at most 2^33 - 2. At G = 2 the carry
// into word 1 is word 0's carry-out, one shuffle.
template <int G>
__device__ __forceinline__ uint32_t group_add(const LaneGroup<G>& g, uint32_t x, uint32_t y) {
  const uint32_t s = x + y;
  if constexpr (G == 1) {
    return s;
  } else if constexpr (G == 2) {  // word 1's carry is word 0's carry-out
    return s + g.from_below(s < x ? 1u : 0u, 0u);
  } else {
    const unsigned gen = g.ballot(s < x);
    const unsigned prop = g.ballot(s == 0xFFFFFFFFu);
    const unsigned a = gen | prop;
    return s + ((((a + gen) ^ a ^ gen) >> g.lane) & 1u);
  }
}

// The group's first set bit of `cand` (its lowest lane with one, that lane's
// lowest bit) goes into `bits`; true when the group had one. The jaro greedy
// step flags a b-position with it, the multiset counts consume one.
template <int G>
__device__ __forceinline__ bool take_first(const LaneGroup<G>& g, uint32_t cand, uint32_t& bits) {
  const unsigned any = g.ballot(cand != 0u);
  if (g.lane == __ffs(any) - 1) bits |= cand & (0u - cand);
  return any != 0u;
}

// --- the recurrences, one word a lane ------------------------------------
// Myers/Hyyro, Hyyro's OSA and Allison-Dix's LCS over one 32-bit word a lane
// (the plain forms: ops/bitwords.py and the recurrences it serves), the
// addition carry by group_add and the shift-ins by from_below.
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

// By compares with the word's first N chars (N = 8, 16 or 32: as many as the
// width can give a lane), held in registers.
template <typename T, int N>
struct RegisterEq {
  T c[N];
  uint32_t valid;

  __device__ __forceinline__ RegisterEq(uint32_t*, int, const T* s, int count)
      : valid(low_bits(count)) {
#pragma unroll
    for (int k = 0; k < N; ++k) c[k] = k < count ? s[k] : 0;
  }
  __device__ __forceinline__ uint32_t operator()(T ch) const {
    uint32_t e = 0u;
#pragma unroll
    for (int k = 0; k < N; ++k) e |= (uint32_t)(c[k] == ch) << k;
    return e & valid;
  }
};

// Chars of a lane's word that a width leaves: 8, 16 or 32.
__host__ __device__ constexpr int lane_chars(int L) { return L <= 8 ? 8 : L <= 16 ? 16 : 32; }

// The equality words a kernel reads on tiles of T whose lanes hold N chars:
// the table on int8 tiles with whole words; compares on int32 tiles, whose
// codepoints cannot index a table, and on int8 tiles of at most 16 chars,
// where a handful of compares costs less than the table's 16 KB of shared
// memory a warp (it bounds the warps an SM holds).
template <typename T, int N = 32>
constexpr bool lane_table = sizeof(T) == 1 && N == 32;

template <typename T, int N = 32>
using LaneEq = std::conditional_t<lane_table<T, N>, TableEq, RegisterEq<T, N>>;

// --- staging ---------------------------------------------------------------

// Bytes of a warp's staging area for `rows` rows of 2L chars of T.
template <typename T>
__host__ __device__ constexpr int stage_bytes(int rows, int L) {
  return ((rows * 2 * L * (int)sizeof(T) + kStageSlack) + 15) & ~15;
}

// Bytes of a warp's shared memory for LaneEq<T, N> and the staged rows of
// 32 / G row pairs of width L: the table, if it reads one, then the rows.
template <typename T, int G, int N = 32>
__host__ __device__ constexpr int lane_warp_bytes(int L) {
  return (lane_table<T, N> ? kTableBytes : 0) + stage_bytes<T>(kWarp / G, L);
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

// --- jaro's transpositions -----------------------------------------------

// Bytes of a warp's rank slots for groups of G lanes: 2 x 32G of every group
// above G = 2, none below.
template <int G>
constexpr int kRankSlotBytes = G > 2 ? 64 * kWarp * 4 : 0;

// t for the group's m jaro matches: the ranks r at which the r-th matched a
// char (the bits of `mat`, a-positions) differs from the r-th flagged b char
// (the bits of `flag`). sa and sb are the row's staged chars.
//   * G <= 2: each lane walks the row's (at most) two words of both sets,
//     the other lane's by one shuffle, in registers;
//   * G > 2: each lane's popcounts, scanned over the group, give the ranks;
//     the lanes write their matched a chars and flagged b chars in rank
//     order to `scratch` (kRankSlotBytes<G> a warp) and compare them in
//     parallel. Rank slot s of the group is word (s / G) * 32 + base + s % G
//     of the scratch, a's ranks at s < 32G, b's from 32G, so that lane k
//     reads its own column. The caller makes sure no lane of the group still
//     reads what the scratch overlays.
template <typename T, int G>
__device__ __forceinline__ int jaro_transpositions(const LaneGroup<G>& g, uint32_t* scratch,
                                                   const T* sa, const T* sb, uint32_t mat,
                                                   uint32_t flag, int m) {
  if constexpr (G <= 2) {
    uint64_t ma = mat, fb = flag;
    if constexpr (G == 2) {
      const uint64_t om = __shfl_xor_sync(kFull, mat, 1), of = __shfl_xor_sync(kFull, flag, 1);
      ma = g.lane ? om | ma << 32 : ma | om << 32;
      fb = g.lane ? of | fb << 32 : fb | of << 32;
    }
    int t = 0;
    for (; fb; fb &= fb - 1u, ma &= ma - 1u) t += sa[__ffsll(ma) - 1] != sb[__ffsll(fb) - 1] ? 1 : 0;
    return t;
  } else {
    const int base = 32 * g.lane;
    const auto slot = [&](int s) { return ((s / G) << 5) + g.base + (s & (G - 1)); };
    int s = g.exclusive_sum(__popc(mat));
    for (uint32_t x = mat; x; x &= x - 1u) scratch[slot(s++)] = (uint32_t)(int)sa[base + __ffs(x) - 1];
    s = 32 * G + g.exclusive_sum(__popc(flag));
    for (uint32_t x = flag; x; x &= x - 1u) scratch[slot(s++)] = (uint32_t)(int)sb[base + __ffs(x) - 1];
    g.sync();
    int t = 0;
    for (int q = g.lane; q < m; q += G) t += scratch[slot(q)] != scratch[slot(32 * G + q)] ? 1 : 0;
    return g.sum(t);
  }
}

// G for a width: its word count rounded up to a power of two
__host__ __device__ constexpr int group_lanes(int words) {
  return words <= 1 ? 1 : words <= 2 ? 2 : words <= 4 ? 4 : words <= 8 ? 8 : 16;
}

}  // namespace
}  // namespace strsim
