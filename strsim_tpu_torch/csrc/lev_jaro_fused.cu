// Shared-equality fused stats: lev_d, jaro_m, jaro_t, prefix and optionally
// inter, osa_d and lcs_len in one pass, one thread per row pair, widths <= 64.
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
// What bounds it on this card: building the equality words, la * lb char
// compares a row from L1-resident rows, as in the Myers kernel alone; the
// separate kernels each redo a share of those compares (the jaro window, the
// multiset count of b) and read the tiles again.
//
// What the design does about it: for each a-position i the thread builds the
// W words EqB_i (bit j = b_j == a_i, j < lb) once and feeds three consumers
// from registers:
//   * the jaro greedy step takes the lowest unflagged bit of EqB_i inside the
//     window [max(i - bound, 0), min(i + bound, lb - 1)];
//   * the multiset step takes cnt_b(a_i) = popcount(EqB_i), so only the
//     occurrence rank of a_i among a[:i] is counted fresh;
//   * the Myers step runs with b as the pattern and a as the text, for which
//     EqB_i is exactly the Eq word of text char a_i. The TPU kernel kept a as
//     the pattern and bit-transposed the stored EqB matrix for it; edit
//     distance is symmetric, so swapping the roles needs neither the L x W
//     stored words nor the transpose. Rows with an empty side are not
//     distances (the finalizer ignores them); for those the kernel returns
//     what the a-pattern recurrence returns: la == 0 gives max(lb - 1, 0),
//     lb == 0 gives la;
//   * the OSA step (Hyyro's D0 form) and the LCS step (Allison-Dix) run the
//     same way, b as the pattern, on the same EqB_i word (steps from
//     bitdp.cuh). OSA distance and LCS length are symmetric too; on rows
//     with an empty side osa_d follows the a-pattern recurrence as lev_d
//     does, and lcs_len is 0 in either orientation.
// t is the two-pointer walk over the matched-a and flagged-b bit sets of
// jaro_scan.cu, exact for every codepoint on int8 and int32 tiles.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitdp.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWords = 2;

using strsim::low_bits;

template <int W>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&v)[W], int k) {
  uint32_t out = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == k) out = v[w];
  return out;
}

template <typename T, int W, bool kInter, bool kOsa, bool kLcs>
__global__ void lev_jaro_kernel(const T* __restrict__ a,
                                const T* __restrict__ b, long long stride_a,
                                long long stride_b,
                                const int* __restrict__ len_a,
                                const int* __restrict__ len_b,
                                int* __restrict__ lev_out,
                                int* __restrict__ m_out,
                                int* __restrict__ t_out,
                                int* __restrict__ prefix_out,
                                int* __restrict__ inter_out,
                                int* __restrict__ osa_out,
                                int* __restrict__ lcs_out, int n, int L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* ar = a + (long long)r * stride_a;
  const T* br = b + (long long)r * stride_b;
  const int la = len_a[r];
  const int lb = len_b[r];
  const int na = min(max(la, 0), L);
  const int nb = min(max(lb, 0), L);

  // jaro window (jaro_scan.cu)
  const int bound = max(la, lb) / 2 - 1;
  const int i_end = min(min(la, lb + bound), L);
  const int j_last = nb - 1;
  // Myers with pattern b: the score tracks bit nb - 1
  const int m1 = max(nb - 1, 0);
  const int hword = m1 >> 5;
  const unsigned hbit = (unsigned)(m1 & 31);

  uint32_t pv[W], mv[W], flag[W], mat[W], opv[W], omv[W], d0p[W], pmo[W], v[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pv[w] = opv[w] = v[w] = 0xFFFFFFFFu;
    mv[w] = omv[w] = d0p[w] = pmo[w] = 0u;
    flag[w] = 0u;
    mat[w] = 0u;
  }
  int score = nb, osa = nb, m = 0, inter = 0;

  for (int i = 0; i < na; ++i) {
    const T c = ar[i];
    uint32_t eq[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      eq[w] = 0u;
      const int j1 = min(w * 32 + 32, nb);
      for (int j = w * 32; j < j1; ++j) eq[w] |= (uint32_t)(br[j] == c) << (j - w * 32);
    }

    if (i < i_end) {  // jaro greedy step: first unflagged match in the window
      const int lo = max(i - bound, 0);
      const int hi = min(i + bound, j_last);
      bool found = false;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t win = low_bits(hi + 1 - w * 32) & ~low_bits(lo - w * 32);
        const uint32_t cand = eq[w] & ~flag[w] & win;
        if (!found && cand) {
          flag[w] |= cand & (0u - cand);
          found = true;
        }
      }
      if (found) {
        ++m;
#pragma unroll
        for (int w = 0; w < W; ++w)
          if (w == (i >> 5)) mat[w] |= 1u << (i & 31);
      }
    }

    if (kInter) {  // a_i counts iff its rank among equal chars of a < cnt_b
      int cnt = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) cnt += __popc(eq[w]);
      int occ = 0;
      for (int k = 0; k < i && occ < cnt; ++k) occ += ar[k] == c ? 1 : 0;
      inter += occ < cnt ? 1 : 0;
    }

    // text char a_i against pattern b (roles swapped, see above)
    score += strsim::myers_step<W>(eq, pv, mv, hword, hbit);
    if (kOsa) osa += strsim::osa_step<W>(eq, opv, omv, d0p, pmo, hword, hbit);
    if (kLcs) strsim::lcs_step<W>(eq, v);
  }

  // r-th matched a-position against r-th flagged b-position (jaro_scan.cu)
  int t = 0;
  int ka = 0;
  uint32_t rest_a = mat[0];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    uint32_t f = flag[w];
    while (f) {
      const int jb = w * 32 + __ffs(f) - 1;
      f &= f - 1u;
      while (rest_a == 0u && ka < W - 1) rest_a = word_at<W>(mat, ++ka);
      const int ia = ka * 32 + __ffs(rest_a) - 1;
      rest_a &= rest_a - 1u;
      t += ar[ia] != br[jb] ? 1 : 0;
    }
  }
  if (la == 1 && lb == 1) {  // direct compare (strsim.rs:197-199)
    m = ar[0] == br[0] ? 1 : 0;
    t = 0;
  }

  int prefix = 0;  // pads differ per side, so no length mask is needed
  const int k_max = min(L, 4);
  while (prefix < k_max && ar[prefix] == br[prefix]) ++prefix;

  lev_out[r] = la == 0 ? max(lb - 1, 0) : (lb == 0 ? la : score);
  m_out[r] = m;
  t_out[r] = t;
  prefix_out[r] = prefix;
  if (kInter) inter_out[r] = inter;
  if (kOsa) osa_out[r] = la == 0 ? max(lb - 1, 0) : (lb == 0 ? la : osa);
  if (kLcs) lcs_out[r] = strsim::lcs_length<W>(v, nb);
}

template <typename T, int W>
cudaError_t launch_w(const void* a, const void* b, long long sa, long long sb,
                     const int* la, const int* lb, int* lev, int* m, int* t,
                     int* prefix, int* inter, int* osa, int* lcs, int n, int L,
                     cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const int flags = (inter != nullptr) | (osa != nullptr) << 1 | (lcs != nullptr) << 2;
  switch (flags) {
#define STRSIM_CASE(F, I_, O_, C_)                                           \
  case F:                                                                    \
    lev_jaro_kernel<T, W, I_, O_, C_><<<grid, block, 0, stream>>>(          \
        ta, tb, sa, sb, la, lb, lev, m, t, prefix, inter, osa, lcs, n, L);   \
    break;
    STRSIM_CASE(0, false, false, false)
    STRSIM_CASE(1, true, false, false)
    STRSIM_CASE(2, false, true, false)
    STRSIM_CASE(3, true, true, false)
    STRSIM_CASE(4, false, false, true)
    STRSIM_CASE(5, true, false, true)
    STRSIM_CASE(6, false, true, true)
    STRSIM_CASE(7, true, true, true)
#undef STRSIM_CASE
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int words, const void* a, const void* b, long long sa,
                   long long sb, const int* la, const int* lb, int* lev,
                   int* m, int* t, int* prefix, int* inter, int* osa, int* lcs,
                   int n, int L, cudaStream_t stream) {
  if (words == 1)
    return launch_w<T, 1>(a, b, sa, sb, la, lb, lev, m, t, prefix, inter, osa, lcs, n, L, stream);
  return launch_w<T, 2>(a, b, sa, sb, la, lb, lev, m, t, prefix, inter, osa, lcs, n, L, stream);
}

}  // namespace

// Row r of a starts at a + r * stride_a elements (likewise b). elem_bytes:
// 1 (int8) or 4 (int32). inter_out, osa_out and lcs_out may be null: that
// step is then compiled out. Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_lev_jaro_fused(const void* a, const void* b,
                                     long long stride_a, long long stride_b,
                                     const void* len_a, const void* len_b,
                                     void* lev_out, void* m_out, void* t_out,
                                     void* prefix_out, void* inter_out,
                                     void* osa_out, void* lcs_out, int n,
                                     int L, int elem_bytes, void* stream) {
  const int words = (L + 31) / 32;
  if (n <= 0 || L <= 0 || words > kMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* lev = static_cast<int*>(lev_out);
  int* m = static_cast<int*>(m_out);
  int* t = static_cast<int*>(t_out);
  int* prefix = static_cast<int*>(prefix_out);
  int* inter = static_cast<int*>(inter_out);
  int* osa = static_cast<int*>(osa_out);
  int* lcs = static_cast<int*>(lcs_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)launch<int8_t>(words, a, b, stride_a, stride_b, la, lb, lev, m,
                               t, prefix, inter, osa, lcs, n, L, s);
  if (elem_bytes == 4)
    return (int)launch<int32_t>(words, a, b, stride_a, stride_b, la, lb, lev,
                                m, t, prefix, inter, osa, lcs, n, L, s);
  return (int)cudaErrorInvalidValue;
}
