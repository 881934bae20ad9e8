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
// 3.35 TB/s; at [8, 128] that is a few ns and the launch itself (a few
// microseconds, mostly the host's) is the whole time.
//
// Design: where x and out lie at the same offset from a 16-byte boundary,
// each thread moves four elements a step with 16-byte loads and stores
// (int4), the at most three elements before the first boundary and after
// the last whole vector by single accesses; otherwise every element by
// single accesses (an offset view against a fresh output). A grid of at
// most kBlocksPerSm blocks an SM, each thread striding over the grid, so any
// size fits one launch. The arithmetic is done unsigned, so it wraps modulo
// 2^32 as int32 arithmetic does in torch and in JAX, without signed
// overflow.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads: a full SM

__device__ __forceinline__ int warm1(int v) { return (int)((unsigned)v * 2u + 1u); }

// head single elements, then vecs int4 vectors, then single elements to n
__global__ void __launch_bounds__(kThreads)
    warm_kernel(const int* __restrict__ x, int* __restrict__ out, long long n, int head,
                long long vecs) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int4* xv = reinterpret_cast<const int4*>(x + head);
  int4* ov = reinterpret_cast<int4*>(out + head);
  for (long long i = tid; i < vecs; i += stride) {
    int4 v = xv[i];
    v.x = warm1(v.x);
    v.y = warm1(v.y);
    v.z = warm1(v.z);
    v.w = warm1(v.w);
    ov[i] = v;
  }
  if (tid < head) out[tid] = warm1(x[tid]);
  for (long long i = head + 4 * vecs + tid; i < n; i += stride) out[i] = warm1(x[i]);
}

int sm_count() {
  static const int sms = [] {
    int device = 0, count = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    return count;
  }();
  return sms;
}

}  // namespace

// x, out: n int32 on the device, each contiguous (any 4-byte offset).
// Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_warm(const void* x, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  const unsigned mis = (unsigned)((uintptr_t)x & 15);
  int head = 0;
  long long vecs = 0;
  if (mis == (unsigned)((uintptr_t)out & 15) && mis % 4 == 0) {
    head = (int)(((16 - mis) & 15) / 4 < n ? ((16 - mis) & 15) / 4 : n);
    vecs = (n - head) / 4;
  }
  const long long work = vecs > 0 ? vecs : n;  // a thread's first element or vector
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > (long long)kBlocksPerSm * sms) blocks = (long long)kBlocksPerSm * sms;
  warm_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)x, (int*)out, n, head, vecs);
  return (int)cudaGetLastError();
}
