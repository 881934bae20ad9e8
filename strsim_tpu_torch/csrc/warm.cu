// K11: out[i] = x[i] * 2 + 1 over an int32 tensor.
//
// Replaces bench.py:685 `k` (launched by pl.pallas_call at bench.py:690,
// inside _mosaic_init_warm), which ran once on an int32 [8, 128] tile to
// pay the TPU compiler's first initialisation before the benchmark's timed
// sections. Its counterpart here is the first build and launch of the
// toolchain the port's kernels use: nvcc for sm_90a, a plain C entry point
// loaded with ctypes (ops/_build.py). bench_torch.py starts every build at
// t = 0 and launches this kernel once on [8, 128] after it, timing both.
//
// What bounds it on this card: 8 bytes an element (4 read, 4 written) over
// 3.35 TB/s, a few ns at [8, 128]; at that size the launch itself (a few
// microseconds) is the whole time, so it is launch-bound.
//
// Design: one thread an element, 256 threads a block, a grid-stride loop so
// any size fits one launch. The arithmetic is done unsigned, so it wraps
// modulo 2^32 as int32 arithmetic does in torch and in JAX, without signed
// overflow.
#include <cuda_runtime.h>

namespace {

__global__ void warm_kernel(const int* __restrict__ x, int* __restrict__ out, long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = (int)((unsigned)x[i] * 2u + 1u);
  }
}

}  // namespace

// x, out: n contiguous int32 on the device. Returns the launch's cudaError_t
// (0 on success).
extern "C" int strsim_warm(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  warm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, n);
  return (int)cudaGetLastError();
}
