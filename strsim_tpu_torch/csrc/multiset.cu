// Character-multiset intersection sum_c min(cnt_a(c), cnt_b(c)), one thread
// per row pair, in two forms.
//
// strsim_multiset_rank replaces strsim_tpu/ops/multiset_pallas.py:_kernel
// (behind multiset_intersection_pallas, widths <= 64): the occurrence-rank
// identity, position i < la of a counts iff the number of equal chars before
// it in a is below the count of that char in b[:lb]. O(la * (la + lb))
// compares a row, all from L1-resident rows; at L <= 64 that is cheaper than
// clearing a histogram, and it takes any codepoint, int8 or int32.
//
// strsim_multiset_hist replaces multiset_pallas.py:_kernel_hist (behind
// multiset_intersection_hist): wide buckets of 8-bit tiles. The TPU looped
// over each block's [cmin, cmax] char range, O(range * L) lane ops. Here each
// thread owns a 128-bin count of a[:la] in shared memory and consumes it with
// b[:lb]: O(la + lb + 128) a row. Chars are read as signed int8, so the pads
// (-1, -2) fall outside the bins and exclude themselves. The bins are 16-bit,
// laid out [bin][thread] so that a warp's threads touch consecutive words: 32
// KB of shared memory for a block of 128 threads.
//
// Both match the plain torch versions in strsim_tpu_torch/ops/multiset_cuda.py
// on every row; both read lengths, so padded rows (la = lb = 0) give 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBins = 128;

template <typename T>
__global__ void rank_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            long long stride_a, long long stride_b,
                            const int* __restrict__ len_a,
                            const int* __restrict__ len_b,
                            int* __restrict__ out, int n, int L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* ar = a + (long long)r * stride_a;
  const T* br = b + (long long)r * stride_b;
  const int na = min(max(len_a[r], 0), L);
  const int nb = min(max(len_b[r], 0), L);
  int inter = 0;
  for (int i = 0; i < na; ++i) {
    const T c = ar[i];
    int occ = 0;
    for (int k = 0; k < i; ++k) occ += ar[k] == c ? 1 : 0;
    int cnt = 0;
    for (int j = 0; j < nb && cnt <= occ; ++j) cnt += br[j] == c ? 1 : 0;
    inter += occ < cnt ? 1 : 0;
  }
  out[r] = inter;
}

__global__ void hist_kernel(const int8_t* __restrict__ a,
                            const int8_t* __restrict__ b, long long stride_a,
                            long long stride_b, const int* __restrict__ len_a,
                            const int* __restrict__ len_b,
                            int* __restrict__ out, int n, int L) {
  __shared__ uint16_t bins[kBins * kThreads];
  const int tid = threadIdx.x;
  const int r = blockIdx.x * blockDim.x + tid;
  if (r >= n) return;  // no barrier below: each thread owns its bin column
  uint16_t* mine = bins + tid;
#pragma unroll 8
  for (int c = 0; c < kBins; ++c) mine[c * kThreads] = 0;
  const int8_t* ar = a + (long long)r * stride_a;
  const int8_t* br = b + (long long)r * stride_b;
  const int na = min(max(len_a[r], 0), L);
  const int nb = min(max(len_b[r], 0), L);
  for (int i = 0; i < na; ++i) {
    const int c = ar[i];
    if (c >= 0) mine[c * kThreads] += 1;
  }
  int inter = 0;
  for (int j = 0; j < nb; ++j) {
    const int c = br[j];
    if (c >= 0) {
      const uint16_t v = mine[c * kThreads];
      if (v) {
        mine[c * kThreads] = v - 1;
        ++inter;
      }
    }
  }
  out[r] = inter;
}

}  // namespace

// Row r of a starts at a + r * stride_a elements (likewise b). elem_bytes:
// 1 (int8) or 4 (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_multiset_rank(const void* a, const void* b,
                                    long long stride_a, long long stride_b,
                                    const void* len_a, const void* len_b,
                                    void* out, int n, int L, int elem_bytes,
                                    void* stream) {
  if (n <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) {
    rank_kernel<int8_t><<<grid, block, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), stride_a,
        stride_b, la, lb, o, n, L);
  } else if (elem_bytes == 4) {
    rank_kernel<int32_t><<<grid, block, 0, s>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        stride_a, stride_b, la, lb, o, n, L);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// 8-bit tiles only (the wrapper checks the dtype).
extern "C" int strsim_multiset_hist(const void* a, const void* b,
                                    long long stride_a, long long stride_b,
                                    const void* len_a, const void* len_b,
                                    void* out, int n, int L, void* stream) {
  if (n <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  hist_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), stride_a,
      stride_b, static_cast<const int*>(len_a), static_cast<const int*>(len_b),
      static_cast<int*>(out), n, L);
  return (int)cudaGetLastError();
}
