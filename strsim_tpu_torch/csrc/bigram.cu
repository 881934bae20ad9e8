// Bigram multiset intersection with the positional-match and row-equality
// stats, one thread per row pair, widths <= 64.
//
// Replaces strsim_tpu/ops/bigram_pallas.py: _kernel behind
// bigram_stats_pallas, which the JAX engine takes for the bigram measures at
// widths <= 63 and whose ham_m and eq outputs serve hamming and the bigram
// finalizers' equality patch (strsim_tpu/ops/stats.py:535-558). Same integer
// contract as the plain torch version in strsim_tpu_torch/ops/bigram_cuda.py:
//   inter2  sum over bigrams g of min(cnt_a(g), cnt_b(g)): bigram i < la - 1
//           of a counts iff its occurrence rank among equal bigrams of a is
//           below its count among the lb - 1 bigrams of b;
//   ham_m   sum over the whole width of (a_i == b_i);
//   eq      (la == lb) & (ham_m == la).
// Pads (-1 / -2) differ per side and from every char, so a bigram that reaches
// a pad matches nothing across sides and b's bigrams past lb - 1 need no
// compare. A side with fewer than 2 chars gives inter2 = 0.
//
// What bounds it on this card: the occurrence-rank compares, (la - 1) *
// (lb - 1) for the counts in b plus up to (la - 1)^2 / 2 for the ranks in a, a
// row, from L1-resident rows; the tiles themselves are at most 2 * 64 chars a
// row.
//
// What the design does about it: on int8 tiles a bigram packs into one 16-bit
// token (c0 & 0xFF) | (c1 & 0xFF) << 8 of chars widened with their sign, so a
// bigram compare is one compare: PAD_A becomes 0xFF and PAD_B 0xFE, which no
// ASCII char takes, so pad bigrams never match across sides. int32 tiles
// compare a 64-bit key (two 32-bit compares). A bigram absent from b skips the
// rank count, and the rank count stops once it reaches the count in b (as
// multiset.cu's rank kernel does).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWidth = 64;

__device__ __forceinline__ uint32_t bigram_key(const int8_t* p, int i) {
  return (uint32_t)(uint8_t)p[i] | ((uint32_t)(uint8_t)p[i + 1] << 8);
}

__device__ __forceinline__ uint64_t bigram_key(const int32_t* p, int i) {
  return ((uint64_t)(uint32_t)p[i] << 32) | (uint64_t)(uint32_t)p[i + 1];
}

template <typename T>
__global__ void bigram_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              long long stride_a, long long stride_b,
                              const int* __restrict__ len_a,
                              const int* __restrict__ len_b,
                              int* __restrict__ inter_out,
                              int* __restrict__ ham_out,
                              int* __restrict__ eq_out, int n, int L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* ar = a + (long long)r * stride_a;
  const T* br = b + (long long)r * stride_b;
  const int la = len_a[r];
  const int lb = len_b[r];

  int ham = 0;
  for (int i = 0; i < L; ++i) ham += ar[i] == br[i] ? 1 : 0;

  const int ga = min(la, L) - 1;  // bigrams of a (and of b) a row has
  const int gb = min(lb, L) - 1;
  int inter = 0;
  for (int i = 0; i < ga; ++i) {
    const auto key = bigram_key(ar, i);
    int cnt = 0;
    for (int j = 0; j < gb; ++j) cnt += bigram_key(br, j) == key ? 1 : 0;
    int occ = 0;
    for (int k = 0; k < i && occ < cnt; ++k) occ += bigram_key(ar, k) == key ? 1 : 0;
    inter += occ < cnt ? 1 : 0;
  }
  inter_out[r] = inter;
  ham_out[r] = ham;
  eq_out[r] = (la == lb && ham == la) ? 1 : 0;
}

}  // namespace

// Row r of a starts at a + r * stride_a elements (likewise b). elem_bytes:
// 1 (int8) or 4 (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_bigram(const void* a, const void* b, long long stride_a,
                             long long stride_b, const void* len_a,
                             const void* len_b, void* inter_out, void* ham_out,
                             void* eq_out, int n, int L, int elem_bytes,
                             void* stream) {
  if (n <= 0 || L <= 0 || L > kMaxWidth) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* inter = static_cast<int*>(inter_out);
  int* ham = static_cast<int*>(ham_out);
  int* eq = static_cast<int*>(eq_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    bigram_kernel<int8_t><<<grid, block, 0, s>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), stride_a,
        stride_b, la, lb, inter, ham, eq, n, L);
  else if (elem_bytes == 4)
    bigram_kernel<int32_t><<<grid, block, 0, s>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        stride_a, stride_b, la, lb, inter, ham, eq, n, L);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
