// Shared-equality fused stats: lev_d, jaro_m, jaro_t, prefix and optionally
// inter, osa_d and lcs_len in one pass, a group of lanes per row pair,
// widths <= 64.
//
// Replaces strsim_tpu/ops/lev_jaro_pallas.py: _kernel (with _transpose_bits
// and _transpose_eq) behind fused_stats_pallas and lev_jaro_stats_pallas,
// which the JAX engine takes when lev and jaro are requested together at
// widths <= 63 (strsim_tpu/ops/stats.py:326-374). Same integer contract, row
// for row, as the plain torch version in strsim_tpu_torch/ops/lev_jaro_cuda.py,
// which runs the separate plain versions: lev_d as levenshtein_myers.cu, m/t
// as jaro_scan.cu (len-1/len-1 patch included), inter as multiset.cu's
// occurrence-rank form, prefix as the 4-capped common prefix of the tiles,
// osa_d as osa_scan.cu and lcs_len as dp_fused.cu's LCS.
//
// What bounds it on this card: per row and a-position, the equality word of
// a_i over b (lb compares if built naively) and about 45 word operations of
// the five consumers below; rows are at most 2 x 64 chars, so issue rate and
// latency bound it, not memory bandwidth.
//
// The design (lanes.cuh, as the scan kernel of dp_scan.cuh and K2): a group
// of G lanes per row pair, G = 1 at widths <= 32 and 2 above, lane w holding
// word w (b-positions 32w .. 32w + 31) of every bit vector. A warp stages its
// rows in shared memory once with coalesced loads; no lane reads a char from
// device memory after that. b is the pattern: EqB_i (bit j = b_j == a_i,
// j < lb) is one read of a per-row table of b on int8 rows wider than 16
// chars, and 8, 16 or 32 register compares (what the width leaves a lane) on
// narrower int8 rows, whose warps then need no 16 KB table, and on int32
// tiles. Each a-position's word feeds five consumers:
//   * the jaro greedy step: candidates EqB_i & window & ~flag, the group's
//     first one flagged (take_first), a's matched bit set (jaro_scan.cu);
//   * the multiset count `inter`, by greedy consumption: a second vector
//     `taken` with no window; a_i counts iff EqB_i & ~taken has a bit, and
//     the group's first such bit is taken. This is the rank rule of the
//     contract (a_i counts iff its rank among equal chars of a is below
//     cnt_b(a_i)): each b-position holds one char, so the bits that
//     different chars take never overlap, and the bits of EqB_i already
//     taken are exactly those the earlier counted occurrences of a_i took,
//     min(rank, cnt_b(a_i)) of them. So the first cnt_b(c) occurrences of c
//     in a each find a free bit and the later ones find none;
//   * the Myers step with b as the pattern and a as the text, for which
//     EqB_i is the Eq word of text char a_i (myers_lane, the score tracked at
//     bit nb - 1). The TPU kernel kept a as the pattern and bit-transposed
//     the stored EqB matrix for it; edit distance is symmetric, so swapping
//     the roles needs neither the stored words nor the transpose. Rows with
//     an empty side are not distances (the finalizer ignores them); for
//     those the kernel returns what the a-pattern recurrence returns: la == 0
//     gives max(lb - 1, 0), lb == 0 gives la;
//   * the OSA step (Hyyro's D0 form, osa_lane) and the LCS step (Allison-Dix,
//     lcs_lane) the same way. OSA distance and LCS length are symmetric too;
//     on rows with an empty side osa_d follows the a-pattern recurrence as
//     lev_d does, and lcs_len is 0 in either orientation.
// t comes from the matched and flagged bits by jaro_transpositions (a walk
// over the row's words in registers), prefix from the staged rows; chars are
// compared as they are, exact for every codepoint on int8 and int32 tiles.
// The kernel is templated on G, the chars a lane holds and the inter, OSA
// and LCS flags, so a step that is off is compiled out.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxWords = 2;

// Blocks an SM holds: with the int8 table shared memory allows 3 (69..74 KB
// a block); without it registers decide.
constexpr int kBlocksPerSm = 3;

template <typename T, int G, int N, bool kInter, bool kOsa, bool kLcs>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    lev_jaro_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                    long long stride_b, const int* __restrict__ len_a,
                    const int* __restrict__ len_b, int* __restrict__ lev_out,
                    int* __restrict__ m_out, int* __restrict__ t_out,
                    int* __restrict__ prefix_out, int* __restrict__ inter_out,
                    int* __restrict__ osa_out, int* __restrict__ lcs_out, int n, int L,
                    bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = kWarp / G;
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kRows;
  if (r0 >= n) return;
  const int rows = (int)min((long long)kRows, (long long)n - r0);
  unsigned char* wsm = smem + (size_t)warp * lane_warp_bytes<T, G, N>(L);
  uint32_t* table_words = reinterpret_cast<uint32_t*>(wsm);
  if constexpr (lane_table<T, N>) clear_table(table_words, wl);
  const T* staged = stage_rows<T>(wsm + (lane_table<T, N> ? kTableBytes : 0), a, b, stride_a,
                                  stride_b, r0, rows, L, packed, wl);
  __syncwarp();

  // every lane stays to the end: the collectives take the whole warp; a
  // group past the last row runs no step and writes nothing
  const LaneGroup<G> g;
  const int k = wl / G;  // the group's row in the warp
  const bool live = k < rows;
  const long long r = r0 + (live ? k : 0);
  const T* sa = staged + 2LL * L * (live ? k : 0);
  const T* sb = sa + L;
  const int la = live ? len_a[r] : 0;
  const int lb = live ? len_b[r] : 0;
  const int na = min(max(la, 0), L);  // the a-positions: one step each
  const int nb = min(max(lb, 0), L);  // pattern positions that can set Eq bits
  const int base = 32 * g.lane;       // b- and a-positions of this lane's word
  const int own = min(max(nb - base, 0), 32);
  // the jaro window (jaro_scan.cu)
  const bool one_one = la == 1 && lb == 1;  // compared directly below
  const int bound = max(la, lb) / 2 - 1;
  const int i_end = one_one ? 0 : max(min(min(la, lb + bound), L), 0);
  // Myers and OSA with pattern b track bit nb - 1
  const int m1 = max(nb - 1, 0);
  const int hword = m1 >> 5;
  const uint32_t tbit = g.lane == hword ? 1u << (m1 & 31) : 0u;
  const int steps = g.warp_max(na);

  uint32_t flag = 0u, mat = 0u, taken = 0u;                  // jaro, multiset
  uint32_t pv = 0xFFFFFFFFu, mv = 0u;                        // Myers
  uint32_t opv = 0xFFFFFFFFu, omv = 0u, d0p = 0u, pmo = 0u;  // OSA
  uint32_t v = 0xFFFFFFFFu;                                  // LCS
  int m = 0, inter = 0, lev = nb, osa = nb;
  const LaneEq<T, N> eq(table_words, wl, sb + base, own);
  uint32_t e_next = eq(sa[0]);
  for (int i = 0; i < steps; ++i) {
    const uint32_t e = e_next;
    e_next = eq(sa[max(min(i + 1, na - 1), 0)]);  // the next step's word, read ahead
    const bool on = G == 1 || i < na;               // this group's row not yet done
    const int lo = max(i - bound, 0) - base;
    const int hi = min(i + bound, nb - 1) - base;
    const uint32_t cand = i < i_end ? e & ones_from(lo) & ~ones_from(hi + 1) & ~flag : 0u;
    if (take_first(g, cand, flag)) {  // the first match in the window
      if (g.lane == (i >> 5)) mat |= 1u << (i & 31);
      ++m;
    }
    if constexpr (kInter) {
      if (take_first(g, on ? e & ~taken : 0u, taken)) ++inter;
    }
    {  // text char a_i against pattern b (roles swapped, see above)
      uint32_t p = pv, q = mv;
      const int d = myers_lane(g, e, p, q, tbit);
      if (on) pv = p, mv = q, lev += d;
    }
    if constexpr (kOsa) {
      uint32_t p = opv, q = omv, d0 = d0p, pm = pmo;
      const int d = osa_lane(g, e, p, q, d0, pm, tbit);
      if (on) opv = p, omv = q, d0p = d0, pmo = pm, osa += d;
    }
    if constexpr (kLcs) {
      uint32_t x = v;
      lcs_lane(g, e, x);
      if (on) v = x;
    }
  }

  const int t = jaro_transpositions(g, nullptr, sa, sb, mat, flag, m);  // G <= 2: no slots
  int lcs = 0;
  if constexpr (kLcs) lcs = nb - g.sum(__popc(v & low_bits(own)));
  if (live && g.lane == hword) {
    int prefix = 0;  // pads differ per side, so no length mask is needed
    const int k_max = min(L, 4);
    while (prefix < k_max && sa[prefix] == sb[prefix]) ++prefix;
    lev_out[r] = la == 0 ? max(lb - 1, 0) : (lb == 0 ? la : lev);
    m_out[r] = one_one ? (sa[0] == sb[0] ? 1 : 0) : m;  // strsim.rs:197-199
    t_out[r] = t;
    prefix_out[r] = prefix;
    if (kInter) inter_out[r] = inter;
    if (kOsa) osa_out[r] = la == 0 ? max(lb - 1, 0) : (lb == 0 ? la : osa);
    if (kLcs) lcs_out[r] = lcs;
  }
}

struct Outs {
  int *lev, *m, *t, *prefix, *inter, *osa, *lcs;
};

template <typename T, int G, int N, bool kInter, bool kOsa, bool kLcs>
cudaError_t launch_g(const T* a, const T* b, long long sa, long long sb, const int* la,
                     const int* lb, const Outs& o, int n, int L, cudaStream_t stream) {
  const int rows_per_block = kWarps * (kWarp / G);
  const int smem = kWarps * lane_warp_bytes<T, G, N>(L);
  const auto kernel = lev_jaro_kernel<T, G, N, kInter, kOsa, kLcs>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  kernel<<<(n + rows_per_block - 1) / rows_per_block, kThreads, smem, stream>>>(
      a, b, sa, sb, la, lb, o.lev, o.m, o.t, o.prefix, o.inter, o.osa, o.lcs, n, L, packed);
  return cudaGetLastError();
}

template <typename T, int G, int N>
cudaError_t launch_flags(const T* a, const T* b, long long sa, long long sb, const int* la,
                         const int* lb, const Outs& o, int n, int L, cudaStream_t stream) {
  const int flags = (o.inter != nullptr) | (o.osa != nullptr) << 1 | (o.lcs != nullptr) << 2;
  switch (flags) {
#define STRSIM_CASE(F, I_, O_, C_) \
  case F: return launch_g<T, G, N, I_, O_, C_>(a, b, sa, sb, la, lb, o, n, L, stream);
    STRSIM_CASE(0, false, false, false)
    STRSIM_CASE(1, true, false, false)
    STRSIM_CASE(2, false, true, false)
    STRSIM_CASE(3, true, true, false)
    STRSIM_CASE(4, false, false, true)
    STRSIM_CASE(5, true, false, true)
    STRSIM_CASE(6, false, true, true)
    default: STRSIM_CASE(7, true, true, true)
#undef STRSIM_CASE
  }
}

template <typename T>
cudaError_t launch(int words, const void* a, const void* b, long long sa, long long sb,
                   const int* la, const int* lb, const Outs& o, int n, int L,
                   cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (words == 2) return launch_flags<T, 2, 32>(ta, tb, sa, sb, la, lb, o, n, L, stream);
  switch (lane_chars(L)) {
    case 8: return launch_flags<T, 1, 8>(ta, tb, sa, sb, la, lb, o, n, L, stream);
    case 16: return launch_flags<T, 1, 16>(ta, tb, sa, sb, la, lb, o, n, L, stream);
    default: return launch_flags<T, 1, 32>(ta, tb, sa, sb, la, lb, o, n, L, stream);
  }
}

}  // namespace
}  // namespace strsim

// Row r of a starts at a + r * stride_a elements (likewise b), so a and b may
// be column slices of one packed [n, 2L] tile. elem_bytes: 1 (int8) or 4
// (int32). inter_out, osa_out and lcs_out may be null: that step is then
// compiled out. Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_lev_jaro_fused(const void* a, const void* b,
                                     long long stride_a, long long stride_b,
                                     const void* len_a, const void* len_b,
                                     void* lev_out, void* m_out, void* t_out,
                                     void* prefix_out, void* inter_out,
                                     void* osa_out, void* lcs_out, int n,
                                     int L, int elem_bytes, void* stream) {
  const int words = (L + 31) / 32;
  if (n <= 0 || L <= 0 || words > strsim::kMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  const strsim::Outs o{static_cast<int*>(lev_out),    static_cast<int*>(m_out),
                       static_cast<int*>(t_out),      static_cast<int*>(prefix_out),
                       static_cast<int*>(inter_out),  static_cast<int*>(osa_out),
                       static_cast<int*>(lcs_out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)strsim::launch<int8_t>(words, a, b, stride_a, stride_b, la, lb, o, n, L, s);
  if (elem_bytes == 4)
    return (int)strsim::launch<int32_t>(words, a, b, stride_a, stride_b, la, lb, o, n, L, s);
  return (int)cudaErrorInvalidValue;
}
