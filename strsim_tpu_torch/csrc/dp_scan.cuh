// The bit-parallel DP scan kernel, one thread per row pair, widths <= 512:
// pattern a, text b, for each text char b_j (j < lb) the W words Eq (bit i =
// a_i == b_j, i < la) are built once and feed the requested recurrences
// (steps from bitdp.cuh):
//   * Myers, score from la, tracking bit la - 1;
//   * Hyyro OSA in the D0 form with the carried D0 and Eq words and the
//     transposition term's inter-word carry;
//   * Allison-Dix LCS from V = all ones; lcs = la - popcount(V & mask(la)).
// Three libraries launch it, each with its own entry point and launch count:
// levenshtein_myers.cu (K1, Myers alone), osa_scan.cu (K7, OSA alone) and
// dp_fused.cu (K6, the other subsets).
//
// The kernel is templated on the word count and on the three flags, so only
// the requested recurrences' state is live and the word loops unroll. Each
// thread runs its own trip count lb; the pipeline sorts rows by la + lb so a
// warp's threads finish together. int8 tiles are read as they are, signed, so
// the pads stay -1 and -2. To bound the build, the word count is rounded up to
// one of 1, 2, 3, 4, 6, 8, 12, 16 (every ladder width has its own: 7..31 -> 1,
// 47/63 -> 2, 95 -> 3, 127 -> 4, 191 -> 6, 255 -> 8, 383 -> 12, 511 -> 16); a
// vector with spare high words gives the same result, since no Eq bit is set
// there and the scores read bit la - 1.
//
// How the Eq words meet the steps was measured on an H100 (PERF.md):
// with one recurrence (K1, K7, LCS alone) each Eq word feeds its step as
// soon as it is built, so one Eq word is live, not W: building all W first
// made K1 up to 1.48x slower on int32 tiles from w191 up. With two or three
// (K6) all W words are built first and each whole-vector step follows:
// feeding them word by word made K6 1.14..1.17x slower on int8 tiles at
// w383 and w511, the main path's wide buckets.
//
// Each including library is one translation unit, so the unnamed namespace
// keeps every instantiation private to its library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitdp.cuh"

namespace strsim {
namespace {

constexpr int kScanThreads = 128;
constexpr int kScanMaxWords = 16;

// Eq word w for text char ch: bit i - 32w = (a_i == ch), i < na
template <typename T>
__device__ __forceinline__ uint32_t eq_word(const T* ar, T ch, int w, int na) {
  uint32_t e = 0u;
  const int i1 = min(w * 32 + 32, na);
  for (int i = w * 32; i < i1; ++i) e |= (uint32_t)(ar[i] == ch) << (i - w * 32);
  return e;
}

template <typename T, int W, bool kLev, bool kOsa, bool kLcs>
__global__ void dp_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                               long long stride_a, long long stride_b,
                               const int* __restrict__ len_a,
                               const int* __restrict__ len_b,
                               int* __restrict__ lev_out,
                               int* __restrict__ osa_out,
                               int* __restrict__ lcs_out, int n, int L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* ar = a + (long long)r * stride_a;
  const T* br = b + (long long)r * stride_b;
  const int la = len_a[r];
  const int na = min(max(la, 0), L);  // pattern positions that can set Eq bits
  const int nb = min(len_b[r], L);
  const int m1 = max(la - 1, 0);
  const int hword = m1 >> 5;  // word holding the tracked bit la - 1
  const unsigned hbit = (unsigned)(m1 & 31);

  uint32_t pv[W], mv[W], opv[W], omv[W], d0p[W], pmo[W], v[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pv[w] = opv[w] = v[w] = 0xFFFFFFFFu;
    mv[w] = omv[w] = d0p[w] = pmo[w] = 0u;
  }
  int lev = la, osa = la;

  for (int j = 0; j < nb; ++j) {
    const T ch = br[j];
    if (kLev + kOsa + kLcs >= 2) {  // all W Eq words, then each whole-vector step
      uint32_t eq[W];
#pragma unroll
      for (int w = 0; w < W; ++w) eq[w] = eq_word(ar, ch, w, na);
      if (kLev) lev += myers_step<W>(eq, pv, mv, hword, hbit);
      if (kOsa) osa += osa_step<W>(eq, opv, omv, d0p, pmo, hword, hbit);
      if (kLcs) lcs_step<W>(eq, v);
    } else {  // each Eq word feeds the one step as soon as it is built
      MyersCarry lev_c;
      OsaCarry osa_c;
      uint32_t lcs_c = 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t e = eq_word(ar, ch, w, na);
        if (kLev) myers_word(e, pv[w], mv[w], lev_c, w == hword, hbit);
        if (kOsa) osa_word(e, opv[w], omv[w], d0p[w], pmo[w], osa_c, w == hword, hbit);
        if (kLcs) lcs_word(e, v[w], lcs_c);
      }
      lev += lev_c.delta;
      osa += osa_c.delta;
    }
  }
  if (kLev) lev_out[r] = lev;
  if (kOsa) osa_out[r] = osa;
  if (kLcs) lcs_out[r] = lcs_length<W>(v, na);
}

template <typename T, int W, bool kLev, bool kOsa, bool kLcs>
cudaError_t launch_dp_scan_w(const T* a, const T* b, long long sa, long long sb,
                             const int* la, const int* lb, int* lev, int* osa,
                             int* lcs, int n, int L, cudaStream_t stream) {
  const dim3 grid((n + kScanThreads - 1) / kScanThreads), block(kScanThreads);
  dp_scan_kernel<T, W, kLev, kOsa, kLcs><<<grid, block, 0, stream>>>(
      a, b, sa, sb, la, lb, lev, osa, lcs, n, L);
  return cudaGetLastError();
}

template <typename T, bool kLev, bool kOsa, bool kLcs>
cudaError_t launch_dp_scan_t(int words, const void* a, const void* b,
                             long long sa, long long sb, const int* la,
                             const int* lb, int* lev, int* osa, int* lcs, int n,
                             int L, cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
#define STRSIM_W(W)                                                  \
  return launch_dp_scan_w<T, W, kLev, kOsa, kLcs>(ta, tb, sa, sb, la, lb, \
                                                  lev, osa, lcs, n, L, stream)
  if (words <= 1) STRSIM_W(1);
  if (words <= 2) STRSIM_W(2);
  if (words <= 3) STRSIM_W(3);
  if (words <= 4) STRSIM_W(4);
  if (words <= 6) STRSIM_W(6);
  if (words <= 8) STRSIM_W(8);
  if (words <= 12) STRSIM_W(12);
  STRSIM_W(16);
#undef STRSIM_W
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
