// Bit-parallel DP steps over W 32-bit words held in the registers of one
// thread, for a kernel that advances one text char at a time from its
// equality words (bit i of the vector = pattern_i == text char):
// lev_jaro_fused.cu (K5), whose jaro step reads the same W words. Carries and
// shift-outs run from word w to word w + 1, as in the plain torch versions
// (strsim_tpu_torch/ops/bitwords.py) and the JAX kernels they replace.
//
// Each recurrence has a per-word form (`*_word`), which advances word w from
// its Eq word, taking word w - 1's carries from a carry record and leaving
// word w's there, and a whole-vector step (`*_step`) that runs it from
// w = 0 up with a fresh record for each text char. lanes.cuh has the same
// recurrences with one word a lane, for the kernels that give a row a group
// of lanes (the scan kernel of dp_scan.cuh, the jaro scan).
//
// The score of the Myers and OSA steps tracks bit `hbit` of word `hword`:
// the pattern's last position. The callers unroll the word loops (W is a
// template parameter), so the arrays stay in registers.
#pragma once

#include <stdint.h>

namespace strsim {

// bits [0, x) set, saturating at 0 and 32
__device__ __forceinline__ uint32_t low_bits(int x) {
  return x <= 0 ? 0u : (x >= 32 ? 0xFFFFFFFFu : (1u << x) - 1u);
}

// --- Myers/Hyyro Levenshtein ---------------------------------------------

struct MyersCarry {
  uint32_t add = 0u, ph = 1u, mh = 0u;  // addition carry, Ph/Mh shift-ins
  int delta = 0;                        // the score's change, set at hword
};

__device__ __forceinline__ void myers_word(uint32_t e, uint32_t& pv,
                                           uint32_t& mv, MyersCarry& c,
                                           bool tracked, unsigned hbit) {
  const uint32_t p = pv, m = mv;
  const uint64_t s = (uint64_t)(e & p) + (uint64_t)p + (uint64_t)c.add;
  c.add = (uint32_t)(s >> 32);
  const uint32_t xh = ((uint32_t)s ^ p) | e;
  const uint32_t xv = e | m;
  const uint32_t ph = m | ~(xh | p);
  const uint32_t mh = p & xh;
  if (tracked)  // the score reads the unshifted Ph/Mh
    c.delta = (int)((ph >> hbit) & 1u) - (int)((mh >> hbit) & 1u);
  const uint32_t ph_s = (ph << 1) | c.ph;
  const uint32_t mh_s = (mh << 1) | c.mh;
  c.ph = ph >> 31;
  c.mh = mh >> 31;
  pv = mh_s | ~(xv | ph_s);
  mv = ph_s & xv;
}

// returns the score delta
template <int W>
__device__ __forceinline__ int myers_step(const uint32_t (&eq)[W],
                                          uint32_t (&pv)[W], uint32_t (&mv)[W],
                                          int hword, unsigned hbit) {
  MyersCarry c;
#pragma unroll
  for (int w = 0; w < W; ++w) myers_word(eq[w], pv[w], mv[w], c, w == hword, hbit);
  return c.delta;
}

// --- Hyyro OSA -----------------------------------------------------------
// The D0 form (strsim_tpu/ops/osa_myers.py): the transposition vector TR
// enters D0 before HP/HN are derived from it. d0p and pmo carry the previous
// text char's D0 and Eq words (zero before the first). TR's shift carries bit
// 31 of word w into word w + 1, like HP's and HN's.

struct OsaCarry {
  uint32_t add = 0u, tr = 0u, hp = 1u, hn = 0u;  // carry and shift-ins
  int delta = 0;
};

__device__ __forceinline__ void osa_word(uint32_t e, uint32_t& pv,
                                         uint32_t& mv, uint32_t& d0p,
                                         uint32_t& pmo, OsaCarry& c,
                                         bool tracked, unsigned hbit) {
  const uint32_t p = pv, m = mv;
  const uint32_t t = ~d0p & e;
  const uint32_t tr = ((t << 1) | c.tr) & pmo;
  c.tr = t >> 31;
  const uint64_t s = (uint64_t)(e & p) + (uint64_t)p + (uint64_t)c.add;
  c.add = (uint32_t)(s >> 32);
  const uint32_t d0 = ((uint32_t)s ^ p) | e | m | tr;
  const uint32_t hp = m | ~(d0 | p);
  const uint32_t hn = d0 & p;
  if (tracked) c.delta = (int)((hp >> hbit) & 1u) - (int)((hn >> hbit) & 1u);
  const uint32_t hp_s = (hp << 1) | c.hp;
  const uint32_t hn_s = (hn << 1) | c.hn;
  c.hp = hp >> 31;
  c.hn = hn >> 31;
  pv = hn_s | ~(d0 | hp_s);
  mv = hp_s & d0;
  d0p = d0;
  pmo = e;
}

template <int W>
__device__ __forceinline__ int osa_step(const uint32_t (&eq)[W],
                                        uint32_t (&pv)[W], uint32_t (&mv)[W],
                                        uint32_t (&d0p)[W], uint32_t (&pmo)[W],
                                        int hword, unsigned hbit) {
  OsaCarry c;
#pragma unroll
  for (int w = 0; w < W; ++w)
    osa_word(eq[w], pv[w], mv[w], d0p[w], pmo[w], c, w == hword, hbit);
  return c.delta;
}

// --- Allison-Dix LCS: U = V & Eq; V = (V + U) | (V ^ U) --------------------

__device__ __forceinline__ void lcs_word(uint32_t e, uint32_t& v,
                                         uint32_t& carry) {
  const uint32_t x = v, u = x & e;
  const uint64_t s = (uint64_t)x + (uint64_t)u + (uint64_t)carry;
  carry = (uint32_t)(s >> 32);
  v = (uint32_t)s | (x ^ u);
}

template <int W>
__device__ __forceinline__ void lcs_step(const uint32_t (&eq)[W],
                                         uint32_t (&v)[W]) {
  uint32_t carry = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w) lcs_word(eq[w], v[w], carry);
}

// LCS length from V (started all ones) for a pattern of length m: carries
// past bit m - 1 never flow back down, so the mask is applied once, here.
template <int W>
__device__ __forceinline__ int lcs_length(const uint32_t (&v)[W], int m) {
  int ones = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) ones += __popc(v[w] & low_bits(m - 32 * w));
  return m - ones;
}

}  // namespace strsim
