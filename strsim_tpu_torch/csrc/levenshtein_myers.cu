// Myers/Hyyro bit-parallel Levenshtein distance, one thread per row pair.
//
// Replaces strsim_tpu/ops/levenshtein_pallas_scan.py: _kernel (W = 1),
// _kernel_multiword (W = 2) and _kernel_wide (W <= 16), all behind
// levenshtein_distance_myers_pallas. Same integer contract as the plain
// torch version in strsim_tpu_torch/ops/levenshtein_cuda.py:
//   pattern = a (bits i < len_a of Eq_j are a_i == b_j), text = b,
//   score starts at len_a, steps j < len_b, the score tracks bit len_a - 1,
//   the addition carry and the Ph/Mh shift-outs run from the low word up.
//
// What bounds it on this card: each step rebuilds the W Eq words from the
// pattern row, len_a compares of chars read from global memory (L1-resident
// after the first step), so a row costs O(len_a * len_b) loads and
// O(W * len_b) word operations. The tiles are small (at most 2 * 511 chars a
// row), so load latency and instruction throughput bound it, not bandwidth.
//
// What the design does about it: pv/mv live in registers (W <= 16 words,
// templated so the word loops unroll), each thread runs its own trip count
// len_b (the TPU kernel needed a per-block maximum as a scalar prefetch),
// and the pipeline sorts rows by len_a + len_b so a warp's threads finish
// together. int8 tiles are read as they are (signed, so the pads stay -1 and
// -2); the TPU widened them to int32 only because Mosaic refuses int8 blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWords = 16;

template <typename T, int W>
__global__ void myers_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             long long stride_a, long long stride_b,
                             const int* __restrict__ len_a,
                             const int* __restrict__ len_b,
                             int* __restrict__ out, int n, int L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* ar = a + (long long)r * stride_a;
  const T* br = b + (long long)r * stride_b;
  const int la = len_a[r];
  const int na = min(max(la, 0), L);  // pattern positions that can set Eq bits
  const int nb = min(len_b[r], L);
  const int m1 = max(la - 1, 0);
  const int hword = m1 >> 5;           // word holding the tracked bit la - 1
  const unsigned hbit = (unsigned)(m1 & 31);

  uint32_t pv[W], mv[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    pv[w] = 0xFFFFFFFFu;
    mv[w] = 0u;
  }
  int score = la;

  for (int j = 0; j < nb; ++j) {
    const T c = br[j];
    uint32_t carry = 0u, ph_in = 1u, mh_in = 0u;
    int ph_bit = 0, mh_bit = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      uint32_t eq = 0u;
      const int i0 = w * 32;
      const int i1 = min(i0 + 32, na);
      for (int i = i0; i < i1; ++i) eq |= (uint32_t)(ar[i] == c) << (i - i0);

      const uint32_t pvw = pv[w], mvw = mv[w];
      const uint32_t x = eq & pvw;
      const uint64_t s = (uint64_t)x + (uint64_t)pvw + (uint64_t)carry;
      carry = (uint32_t)(s >> 32);
      const uint32_t xh = ((uint32_t)s ^ pvw) | eq;
      const uint32_t xv = eq | mvw;
      const uint32_t ph = mvw | ~(xh | pvw);
      const uint32_t mh = pvw & xh;
      if (w == hword) {  // score delta reads the unshifted Ph/Mh
        ph_bit = (int)((ph >> hbit) & 1u);
        mh_bit = (int)((mh >> hbit) & 1u);
      }
      const uint32_t ph_s = (ph << 1) | ph_in;
      const uint32_t mh_s = (mh << 1) | mh_in;
      ph_in = ph >> 31;
      mh_in = mh >> 31;
      pv[w] = mh_s | ~(xv | ph_s);
      mv[w] = ph_s & xv;
    }
    score += ph_bit - mh_bit;
  }
  out[r] = score;
}

template <typename T>
cudaError_t launch(int words, const void* a, const void* b, long long sa,
                   long long sb, const int* la, const int* lb, int* out, int n,
                   int L, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  switch (words) {
#define STRSIM_CASE(W)                                                     \
  case W:                                                                  \
    myers_kernel<T, W><<<grid, block, 0, stream>>>(ta, tb, sa, sb, la, lb, \
                                                   out, n, L);             \
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

// Row r of a starts at a + r * stride_a elements (likewise b), so a and b may
// be column slices of one packed [n, 2L] tile. elem_bytes: 1 (int8) or 4
// (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_levenshtein_myers(const void* a, const void* b,
                                        long long stride_a, long long stride_b,
                                        const void* len_a, const void* len_b,
                                        void* out, int n, int L, int elem_bytes,
                                        void* stream) {
  const int words = (L + 31) / 32;
  if (n <= 0 || L <= 0 || words > kMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)launch<int8_t>(words, a, b, stride_a, stride_b, la, lb, o, n, L, s);
  if (elem_bytes == 4)
    return (int)launch<int32_t>(words, a, b, stride_a, stride_b, la, lb, o, n, L, s);
  return (int)cudaErrorInvalidValue;
}
