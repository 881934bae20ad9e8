// The bit-parallel DP scan kernel, widths <= 512: pattern a, text b; for each
// text char b_j (j < lb) the Eq vector (bit i = a_i == b_j, i < la) feeds the
// requested recurrences:
//   * Myers, score from la, tracking bit la - 1;
//   * Hyyro OSA in the D0 form with the carried D0 and Eq words and the
//     transposition term's carry between words;
//   * Allison-Dix LCS from V = all ones; lcs = la - popcount(V & mask(la)).
// Three libraries launch it, each with its own entry point and launch count:
// levenshtein_myers.cu (K1, Myers alone), osa_scan.cu (K7, OSA alone) and
// dp_fused.cu (K6, the other subsets).
//
// What bounds it on this card: per row and text char, building the Eq vector
// (la compares if done naively) and about 20 word operations per word and
// recurrence; rows are at most 2 x 511 chars, so issue rate and latency bound
// it, not memory bandwidth.
//
// The design (lanes.cuh): a group of G lanes per row pair, G the word count
// rounded up to a power of two, lane w holding word w of each state vector,
// so a lane carries at most 7 state registers (pv/mv, pv/mv/D0'/PM', V). A
// warp stages its rows of the tile into shared memory once, with coalesced
// loads; no lane reads device memory inside the step loop. The Eq word of a
// step costs one shared-memory read on int8 tiles, from a per-row table that
// each lane fills for its own word (one OR per pattern char); on int32 tiles
// a lane compares the text char with its own 32 pattern chars in registers.
// The next step's Eq word is read before the current step runs. The
// addition carry crosses lanes by carry-lookahead on two ballots, the
// shift-ins by one shuffle, both over the whole warp: its 32 lanes stay in
// step, the loop running to the warp's longest row with the finished rows'
// updates masked off (the pipeline sorts rows by la + lb, so a warp's rows
// end close together). The kernel is templated on G and on the three flags,
// so only the requested recurrences' state is live.
//
// Each including library is one translation unit, so the unnamed namespace
// keeps every instantiation private to its library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kScanThreads = 128;
constexpr int kScanWarps = kScanThreads / kWarp;
constexpr int kScanMaxWords = 16;

// Blocks an SM holds, set by shared memory: 3 with the int8 table, 6 on
// int32 tiles. Told so, ptxas keeps the registers that leaves it; told only
// the block size, it spilled to fit blocks that shared memory rules out.
template <typename T>
constexpr int kScanBlocksPerSm = sizeof(T) == 1 ? 3 : 6;

template <typename T, int G, bool kLev, bool kOsa, bool kLcs>
__global__ void __launch_bounds__(kScanThreads, kScanBlocksPerSm<T>)
    dp_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                   long long stride_b, const int* __restrict__ len_a,
                   const int* __restrict__ len_b, int* __restrict__ lev_out,
                   int* __restrict__ osa_out, int* __restrict__ lcs_out, int n, int L,
                   bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kTable = lane_table<T>;
  constexpr int kRows = kWarp / G;
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kScanWarps + warp) * kRows;
  if (r0 >= n) return;
  const int rows = (int)min((long long)kRows, (long long)n - r0);
  unsigned char* wsm = smem + (size_t)warp * lane_warp_bytes<T, G>(L);
  uint32_t* peq = reinterpret_cast<uint32_t*>(wsm);
  if constexpr (kTable) clear_table(peq, wl);
  const T* staged = stage_rows<T>(wsm + (kTable ? kTableBytes : 0), a, b, stride_a, stride_b,
                                  r0, rows, L, packed, wl);
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
  const int na = min(max(la, 0), L);  // pattern positions that can set Eq bits
  const int nb = live ? min(max(len_b[r], 0), L) : 0;
  const int m1 = max(la - 1, 0);
  const int hword = m1 >> 5;  // word holding the tracked bit la - 1
  const int writer = hword * 32 < L ? hword : 0;
  const uint32_t tbit = (g.lane == hword && hword * 32 < L) ? 1u << (m1 & 31) : 0u;
  const int own = min(max(na - 32 * g.lane, 0), 32);  // pattern chars in this lane's word
  const T* mine = sa + 32 * g.lane;
  const int steps = g.warp_max(nb);

  uint32_t pv = 0xFFFFFFFFu, mv = 0u;                        // Myers
  uint32_t opv = 0xFFFFFFFFu, omv = 0u, d0p = 0u, pmo = 0u;  // OSA
  uint32_t v = 0xFFFFFFFFu;                                  // LCS
  int lev = la, osa = la;
  const LaneEq<T> eq(peq, wl, mine, own);
  uint32_t e_next = eq(sb[0]);
  for (int j = 0; j < steps; ++j) {
    const uint32_t e = e_next;
    e_next = eq(sb[max(min(j + 1, nb - 1), 0)]);  // the next step's word, read ahead
    const bool on = G == 1 || j < nb;               // this group's row not yet done
    if (kLev) {
      uint32_t p = pv, m = mv;
      const int d = myers_lane(g, e, p, m, tbit);
      if (on) pv = p, mv = m, lev += d;
    }
    if (kOsa) {
      uint32_t p = opv, m = omv, d0 = d0p, pm = pmo;
      const int d = osa_lane(g, e, p, m, d0, pm, tbit);
      if (on) opv = p, omv = m, d0p = d0, pmo = pm, osa += d;
    }
    if (kLcs) {
      uint32_t x = v;
      lcs_lane(g, e, x);
      if (on) v = x;
    }
  }
  int lcs = 0;
  if (kLcs) lcs = na - g.sum(__popc(v & low_bits(own)));
  if (live && g.lane == writer) {
    if (kLev) lev_out[r] = lev;
    if (kOsa) osa_out[r] = osa;
    if (kLcs) lcs_out[r] = lcs;
  }
}

template <typename T, int G, bool kLev, bool kOsa, bool kLcs>
cudaError_t launch_dp_scan_g(const T* a, const T* b, long long sa, long long sb,
                             const int* la, const int* lb, int* lev, int* osa, int* lcs,
                             int n, int L, cudaStream_t stream) {
  const int rows_per_block = kScanWarps * (kWarp / G);
  const int smem = kScanWarps * lane_warp_bytes<T, G>(L);
  const auto kernel = dp_scan_kernel<T, G, kLev, kOsa, kLcs>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  kernel<<<(n + rows_per_block - 1) / rows_per_block, kScanThreads, smem, stream>>>(
      a, b, sa, sb, la, lb, lev, osa, lcs, n, L, packed);
  return cudaGetLastError();
}

template <typename T, bool kLev, bool kOsa, bool kLcs>
cudaError_t launch_dp_scan_t(int words, const void* a, const void* b, long long sa,
                             long long sb, const int* la, const int* lb, int* lev, int* osa,
                             int* lcs, int n, int L, cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
#define STRSIM_G(G)                                                                  \
  return launch_dp_scan_g<T, G, kLev, kOsa, kLcs>(ta, tb, sa, sb, la, lb, lev, osa, \
                                                  lcs, n, L, stream)
  switch (group_lanes(words)) {
    case 1: STRSIM_G(1);
    case 2: STRSIM_G(2);
    case 4: STRSIM_G(4);
    case 8: STRSIM_G(8);
    default: STRSIM_G(16);
  }
#undef STRSIM_G
}

// The C entry points' common body. Row r of a starts at a + r * stride_a
// elements (likewise b), so a and b may be column slices of one packed
// [n, 2L] tile. elem_bytes: 1 (int8) or 4 (int32). The output pointers of the
// recurrences left out are not touched. Returns the launch's cudaError_t.
template <bool kLev, bool kOsa, bool kLcs>
int launch_dp_scan(const void* a, const void* b, long long stride_a,
                   long long stride_b, const void* len_a, const void* len_b,
                   void* lev_out, void* osa_out, void* lcs_out, int n, int L,
                   int elem_bytes, void* stream) {
  const int words = (L + 31) / 32;
  if (n <= 0 || L <= 0 || words > kScanMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* lev = static_cast<int*>(lev_out);
  int* osa = static_cast<int*>(osa_out);
  int* lcs = static_cast<int*>(lcs_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)launch_dp_scan_t<int8_t, kLev, kOsa, kLcs>(
        words, a, b, stride_a, stride_b, la, lb, lev, osa, lcs, n, L, s);
  if (elem_bytes == 4)
    return (int)launch_dp_scan_t<int32_t, kLev, kOsa, kLcs>(
        words, a, b, stride_a, stride_b, la, lb, lev, osa, lcs, n, L, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace strsim
