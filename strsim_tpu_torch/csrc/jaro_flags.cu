// Jaro greedy match scan with its flags, one thread per row pair.
//
// Replaces strsim_tpu/ops/jaro_pallas.py: _kernel, behind
// jaro_match_stats_pallas (only a forced jaro_impl="pallas" reaches it). Like
// that kernel it runs the greedy scan alone and writes the match count and
// both flag sets; the transposition count and the len-1/len-1 patch run
// outside it, in plain torch (strsim_tpu_torch/ops/jaro_flags_cuda.py), as
// the JAX wrapper runs them in XLA. Same integer contract as
// strsim_tpu_torch/ops/jaro_cuda.py:greedy_scan:
//   bound = max(la, lb) / 2 - 1 (may be -1); a-positions i < min(la, lb + bound)
//   each flag the first unflagged b-position j with b_j == a_i in
//   [max(i - bound, 0), min(i + bound, lb - 1)] and set matched_a[i]; m counts
//   them (0 on len-1/len-1 rows, whose window is empty).
//
// What bounds it on this card: the window search reads up to 2 * bound + 1
// chars of b per a-position (L1-resident), O(la * bound) loads a row, and the
// flag tensors are 2 * L bytes a row to write, the largest part of its bytes
// (262,144 rows at w511 write 268 MB). Instruction throughput and load
// latency bound the scan, as in the jaro scan kernel; the byte writes of one
// thread per row are not coalesced across the warp.
//
// What the design does about it: the scan is the jaro scan kernel's
// (csrc/jaro_scan.cu): flags live in registers as W <= 16 bit words
// (templated on W so the word loops unroll) and the search stops at the
// first candidate word. The TPU kept [L, BR] int32 flag tiles in VMEM and
// wrote them as int32; here they leave the registers once, as one byte per
// position into [B, L] bool tensors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWords = 16;

template <int W>
__device__ __forceinline__ void write_bits(const uint32_t (&v)[W], uint8_t* out, int L) {
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int j1 = min(L, w * 32 + 32);
    for (int j = w * 32; j < j1; ++j) out[j] = (uint8_t)((v[w] >> (j - w * 32)) & 1u);
  }
}

template <typename T, int W>
__global__ void jaro_flags_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                  long long stride_a, long long stride_b,
                                  const int* __restrict__ len_a,
                                  const int* __restrict__ len_b,
                                  int* __restrict__ m_out,
                                  uint8_t* __restrict__ matched_out,
                                  uint8_t* __restrict__ flagged_out, int n, int L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* ar = a + (long long)r * stride_a;
  const T* br = b + (long long)r * stride_b;
  const int la = len_a[r];
  const int lb = len_b[r];
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
  m_out[r] = m;
  write_bits<W>(mat, matched_out + (long long)r * L, L);
  write_bits<W>(flag, flagged_out + (long long)r * L, L);
}

template <typename T>
cudaError_t launch(int words, const void* a, const void* b, long long sa,
                   long long sb, const int* la, const int* lb, int* m,
                   uint8_t* matched, uint8_t* flagged, int n, int L,
                   cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  switch (words) {
#define STRSIM_CASE(W)                                                          \
  case W:                                                                       \
    jaro_flags_kernel<T, W><<<grid, block, 0, stream>>>(ta, tb, sa, sb, la, lb, \
                                                        m, matched, flagged,    \
                                                        n, L);                  \
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

// Row r of a starts at a + r * stride_a elements (likewise b). matched_a and
// flagged_b are contiguous [n, L] arrays of 0/1 bytes (torch.bool), every
// byte written. elem_bytes: 1 (int8) or 4 (int32). Returns the launch's
// cudaError_t (0 on success).
extern "C" int strsim_jaro_flags(const void* a, const void* b,
                                 long long stride_a, long long stride_b,
                                 const void* len_a, const void* len_b,
                                 void* m_out, void* matched_a, void* flagged_b,
                                 int n, int L, int elem_bytes, void* stream) {
  const int words = (L + 31) / 32;
  if (n <= 0 || L <= 0 || words > kMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* m = static_cast<int*>(m_out);
  uint8_t* ma = static_cast<uint8_t*>(matched_a);
  uint8_t* fb = static_cast<uint8_t*>(flagged_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)launch<int8_t>(words, a, b, stride_a, stride_b, la, lb, m, ma, fb, n, L, s);
  if (elem_bytes == 4)
    return (int)launch<int32_t>(words, a, b, stride_a, stride_b, la, lb, m, ma, fb, n, L, s);
  return (int)cudaErrorInvalidValue;
}
