// Jaro match statistics (m, t), one thread per row pair.
//
// Replaces strsim_tpu/ops/jaro_pallas_scan.py: _kernel (L <= 64) and
// _kernel_wide (L <= 512) with _count_unequal_slots, behind
// jaro_match_stats_pallas_scan, including the len-1/len-1 patch it applies
// after the kernel (:400-407). Same integer contract as the plain torch
// version in strsim_tpu_torch/ops/jaro_cuda.py:
//   bound = max(la, lb) / 2 - 1 (may be -1); a-positions i < min(la, lb + bound)
//   each flag the first unflagged b-position j with b_j == a_i in
//   [max(i - bound, 0), min(i + bound, lb - 1)]; m counts them; t counts the
//   ranks r where the r-th matched a char differs from the r-th flagged b
//   char (the reference's ordered zip, strsim.rs:220-237); la == lb == 1
//   gives m = (a_0 == b_0), t = 0 (strsim.rs:197-199).
//
// What bounds it on this card: the window search reads up to 2 * bound + 1
// chars of b per a-position from global memory (L1-resident), O(la * bound)
// loads per row; the flag and match words are W <= 16 registers each. Bound
// by instruction throughput and load latency, like the Myers kernel.
//
// What the design does about it: flags live in registers as bit words
// (templated on W so the word loops unroll) and the search stops at the first
// candidate word. t is a two-pointer walk over the matched-a and flagged-b
// bit sets in rank order, so no compaction is needed: the TPU packed matched
// chars 4, 2 or 1 to an int32 slot to fit its lanes, which made the slot
// width a contract on the codepoint range. Here chars are compared as they
// are, exact for every codepoint, astral ones included, on int8 and int32
// tiles alike.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWords = 16;

template <int W>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&v)[W], int k) {
  uint32_t out = 0u;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == k) out = v[w];
  return out;
}

template <typename T, int W>
__global__ void jaro_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            long long stride_a, long long stride_b,
                            const int* __restrict__ len_a,
                            const int* __restrict__ len_b,
                            int* __restrict__ m_out, int* __restrict__ t_out,
                            int n, int L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* ar = a + (long long)r * stride_a;
  const T* br = b + (long long)r * stride_b;
  const int la = len_a[r];
  const int lb = len_b[r];
  if (la == 1 && lb == 1) {
    m_out[r] = ar[0] == br[0] ? 1 : 0;
    t_out[r] = 0;
    return;
  }
  const int bound = max(la, lb) / 2 - 1;
  const int i_end = min(min(la, lb + bound), L);
  const int j_last = min(lb, L) - 1;

  uint32_t flag[W], mat[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    flag[w] = 0u;
    mat[w] = 0u;
  }
  int m = 0;
  for (int i = 0; i < i_end; ++i) {
    const T c = ar[i];
    const int lo = max(i - bound, 0);
    const int hi = min(i + bound, j_last);
    bool found = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int j0 = max(lo, w * 32);
      const int j1 = min(hi, w * 32 + 31);
      if (!found && j0 <= j1) {
        uint32_t cand = 0u;
        for (int j = j0; j <= j1; ++j) cand |= (uint32_t)(br[j] == c) << (j - w * 32);
        cand &= ~flag[w];
        if (cand) {
          flag[w] |= cand & (0u - cand);  // lowest set bit: the first match
          found = true;
        }
      }
    }
    if (found) {
      ++m;
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (w == (i >> 5)) mat[w] |= 1u << (i & 31);
    }
  }

  // r-th matched a-position against r-th flagged b-position, in rank order
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
  m_out[r] = m;
  t_out[r] = t;
}

template <typename T>
cudaError_t launch(int words, const void* a, const void* b, long long sa,
                   long long sb, const int* la, const int* lb, int* m, int* t,
                   int n, int L, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  switch (words) {
#define STRSIM_CASE(W)                                                    \
  case W:                                                                 \
    jaro_kernel<T, W><<<grid, block, 0, stream>>>(ta, tb, sa, sb, la, lb, \
                                                  m, t, n, L);            \
    break;
    STRSIM_CASE(1) STRSIM_CASE(2) STRSIM_CASE(3) STRSIM_CASE(4)
    STRSIM_CASE(5) STRSIM_CASE(6) STRSIM_CASE(7) STRSIM_CASE(8)
    STRSIM_CASE(9) STRSIM_CASE(10) STRSIM_CASE(11) STRSIM_CASE(12)
    STRSIM_CASE(13) STRSIM_CASE(14) STRSIM_CASE(15) STRSIM_CASE(16)
#undef STRSIM_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Row r of a starts at a + r * stride_a elements (likewise b). elem_bytes:
// 1 (int8) or 4 (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_jaro_scan(const void* a, const void* b,
                                long long stride_a, long long stride_b,
                                const void* len_a, const void* len_b,
                                void* m_out, void* t_out, int n, int L,
                                int elem_bytes, void* stream) {
  const int words = (L + 31) / 32;
  if (n <= 0 || L <= 0 || words > kMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* m = static_cast<int*>(m_out);
  int* t = static_cast<int*>(t_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)launch<int8_t>(words, a, b, stride_a, stride_b, la, lb, m, t, n, L, s);
  if (elem_bytes == 4)
    return (int)launch<int32_t>(words, a, b, stride_a, stride_b, la, lb, m, t, n, L, s);
  return (int)cudaErrorInvalidValue;
}
