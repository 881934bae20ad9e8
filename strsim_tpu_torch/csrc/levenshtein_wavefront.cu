// Levenshtein distance by the full dynamic program, one thread per row pair.
//
// Replaces strsim_tpu/ops/levenshtein_pallas.py: _kernel, behind
// levenshtein_distance_pallas (only a forced levenshtein_impl="pallas"
// reaches it). Same integer contract as the plain torch version in
// strsim_tpu_torch/ops/levenshtein_wavefront_cuda.py:
//   with D[i][j] the edit distance of a[:i] and b[:j], out = D[la][lb] where
//   la + lb >= 2 and 0 where la + lb <= 1 (the TPU wavefront's first
//   capturing diagonal is d = 2).
//
// What bounds it on this card: la * lb cells a row, each a three-way min
// with a char compare, a load and a store of the DP column, and a load of
// the a char (L1-resident after the first column). Bound by instruction
// throughput and local-memory latency, far above the Myers kernel's
// la * lb / 32 word steps: it does the same work as K1 the slow way, and
// stays as the counterpart of the TPU kernel that does the same.
//
// What the design does about it: the TPU kernel advanced a whole block one
// anti-diagonal per step with the block's rows in lanes, so every row paid
// the block's 2L - 1 steps over L + 1 lanes. Here each thread runs the
// classic rolling column over its own row, la + 1 entries of
// local memory (int, so that the threads of a warp touching the same entry
// touch one coalesced line), for exactly lb columns. The pipeline sorts rows
// by la + lb, so a warp's threads finish close together. Chars are compared
// as they are on int8 and int32 tiles; PAD_A and PAD_B are never read.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxWidth = 512;

template <typename T, int LMAX>
__global__ void wavefront_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                 long long stride_a, long long stride_b,
                                 const int* __restrict__ len_a,
                                 const int* __restrict__ len_b,
                                 int* __restrict__ out, int n, int L) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const T* ar = a + (long long)r * stride_a;
  const T* br = b + (long long)r * stride_b;
  const int la = len_a[r];
  const int lb = len_b[r];
  if (la + lb <= 1 || la < 0 || lb < 0 || la > L || lb > L) {  // out of range: 0
    out[r] = 0;
    return;
  }
  int col[LMAX + 1];  // col[i] = D[i][j] for the current column j
  for (int i = 0; i <= la; ++i) col[i] = i;
  for (int j = 1; j <= lb; ++j) {
    const T c = br[j - 1];
    int diag = col[0];  // D[i - 1][j - 1]
    col[0] = j;
    for (int i = 1; i <= la; ++i) {
      const int left = col[i];  // D[i][j - 1]
      const int v = min(min(left, col[i - 1]) + 1, diag + (ar[i - 1] != c ? 1 : 0));
      diag = left;
      col[i] = v;
    }
  }
  out[r] = col[la];
}

template <typename T>
cudaError_t launch(int L, const void* a, const void* b, long long sa, long long sb,
                   const int* la, const int* lb, int* out, int n,
                   cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads), block(kThreads);
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  // the local column is sized for the tile width, rounded up to a power of two
  if (L <= 64)
    wavefront_kernel<T, 64><<<grid, block, 0, stream>>>(ta, tb, sa, sb, la, lb, out, n, L);
  else if (L <= 128)
    wavefront_kernel<T, 128><<<grid, block, 0, stream>>>(ta, tb, sa, sb, la, lb, out, n, L);
  else if (L <= 256)
    wavefront_kernel<T, 256><<<grid, block, 0, stream>>>(ta, tb, sa, sb, la, lb, out, n, L);
  else
    wavefront_kernel<T, kMaxWidth><<<grid, block, 0, stream>>>(ta, tb, sa, sb, la, lb, out, n, L);
  return cudaGetLastError();
}

}  // namespace

// Row r of a starts at a + r * stride_a elements (likewise b), so a and b may
// be column slices of one packed [n, 2L] tile; a row whose lengths are not in
// 0..L gives 0.
// elem_bytes: 1 (int8) or 4 (int32). Returns the launch's cudaError_t (0 on
// success).
extern "C" int strsim_levenshtein_wavefront(const void* a, const void* b,
                                            long long stride_a, long long stride_b,
                                            const void* len_a, const void* len_b,
                                            void* out, int n, int L, int elem_bytes,
                                            void* stream) {
  if (n <= 0 || L <= 0 || L > kMaxWidth) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)launch<int8_t>(L, a, b, stride_a, stride_b, la, lb, o, n, s);
  if (elem_bytes == 4)
    return (int)launch<int32_t>(L, a, b, stride_a, stride_b, la, lb, o, n, s);
  return (int)cudaErrorInvalidValue;
}
