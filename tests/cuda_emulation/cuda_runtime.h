// A CPU stand-in for the CUDA runtime pieces that the lane-group kernels use
// (csrc/dp_scan.cuh, csrc/jaro_scan.cu, csrc/lev_jaro_fused.cu,
// csrc/bigram.cu, csrc/multiset.cu, csrc/probe_jaro.cu, csrc/jaro_flags.cu,
// csrc/levenshtein_wavefront.cu) and the linkage's top k (csrc/topk_scan.cu),
// so that their logic
// runs where there is no card:
// tests/test_torch_lane_kernels_cpu.py compiles those sources with g++
// against this header, as cuda_runtime.h. One std::thread per CUDA thread,
// the blocks of a launch in turn; every warp collective is a rendezvous of
// the lanes its mask names, and a collective that names a lane which has
// already returned aborts instead of hanging. Only what the kernels call is
// here; the test rewrites their launch syntax and their dynamic shared
// memory declaration before compiling.
#pragma once
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(x)
#define __restrict__

struct emu_uint3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local emu_uint3 threadIdx;
inline thread_local emu_uint3 blockIdx;
inline thread_local emu_uint3 blockDim;
inline thread_local emu_uint3 gridDim;
struct uint4 {
  unsigned x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
using std::max;
using std::min;
inline long long min(long long a, long long b) { return a < b ? a : b; }

typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9,
  cudaSharedmemCarveoutMaxShared = 100,
  cudaDevAttrMultiProcessorCount = 16,
};
typedef void* cudaStream_t;
// The current device, and each kernel's dynamic shared memory limit on each
// device, which cudaFuncSetAttribute sets for the current device only, as
// on a card: a launch past its device's limit (48 KB where none was set)
// fails with cudaErrorInvalidValue, which cudaGetLastError then returns.
inline int emu_device = 0;
inline std::map<std::pair<int, const void*>, int> emu_dynamic_smem_limit;
inline cudaError_t emu_last_error = cudaSuccess;
extern "C" __attribute__((weak)) void emu_set_device(int device) { emu_device = device; }
template <class F>
cudaError_t cudaFuncSetAttribute(F kernel, int attr, int value) {
  if (attr == cudaFuncAttributeMaxDynamicSharedMemorySize)
    emu_dynamic_smem_limit[{emu_device, (const void*)kernel}] = value;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t err = emu_last_error;
  emu_last_error = cudaSuccess;
  return err;
}
// the launch's residency: the emulation runs one block at a time
struct cudaFuncAttributes {
  int numRegs = 0;
  size_t localSizeBytes = 0;
};
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* attr, F) {
  *attr = cudaFuncAttributes();
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}
// a card of two SMs, so that a grid sized by SMs still has several blocks
inline cudaError_t cudaGetDevice(int* device) {
  *device = emu_device;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, int attr, int) {
  *value = attr == cudaDevAttrMultiProcessorCount ? 2 : 0;
  return cudaSuccess;
}

// --- one block at a time ----------------------------------------------------

struct EmuRendezvous {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  std::atomic<unsigned long> generation{0};
  uint64_t filling[32], done[32];
};

struct EmuBlock {
  std::mutex m;
  std::condition_variable barrier_cv;  // __syncthreads: every thread of the block
  int barrier_arrived = 0;
  unsigned long barrier_generation = 0;
  std::map<std::pair<int, unsigned>, std::unique_ptr<EmuRendezvous>> rendezvous;
  std::atomic<unsigned> exited[32];  // per warp, the lanes that returned
  unsigned char* smem = nullptr;

  EmuRendezvous& at(int warp, unsigned mask) {
    std::lock_guard<std::mutex> lock(m);
    auto& r = rendezvous[{warp, mask}];
    if (!r) r.reset(new EmuRendezvous);
    return *r;
  }
};
inline EmuBlock* emu_block;

[[noreturn]] inline void emu_fail(const char* what, int warp, unsigned mask) {
  fprintf(stderr, "cuda emulation: %s (warp %d, mask %08x)\n", what, warp, mask);
  abort();
}

// Every lane named in `mask` hands in v; each gets all lanes' values.
inline void emu_collect(unsigned mask, uint64_t v, uint64_t out[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!(mask >> lane & 1u)) emu_fail("lane outside its collective's mask", warp, mask);
  EmuRendezvous& r = emu_block->at(warp, mask);
  std::unique_lock<std::mutex> lock(r.m);
  r.filling[lane] = v;
  const unsigned long generation = r.generation.load();
  if (++r.arrived == __builtin_popcount(mask)) {
    memcpy(r.done, r.filling, sizeof r.done);
    r.arrived = 0;
    r.generation.store(generation + 1);
    r.cv.notify_all();
  } else {
    // a short spin first: woken by the condition variable, every lane would
    // take the lock again in turn
    lock.unlock();
    for (int spin = 0; spin < 256 && r.generation.load() == generation; ++spin) std::this_thread::yield();
    lock.lock();
    while (!r.cv.wait_for(lock, std::chrono::milliseconds(50), [&] { return r.generation.load() != generation; }))
      if (emu_block->exited[warp].load() & mask) emu_fail("collective names a lane that returned", warp, mask);
  }
  lock.unlock();  // done stays until every lane of the mask has reached the next collective
  memcpy(out, r.done, sizeof r.done);
}

inline unsigned __ballot_sync(unsigned mask, int p) {
  uint64_t v[32];
  emu_collect(mask, p != 0, v);
  unsigned bits = 0;
  for (int k = 0; k < 32; ++k)
    if ((mask >> k & 1u) && v[k]) bits |= 1u << k;
  return bits;
}
inline int __any_sync(unsigned mask, int p) { return __ballot_sync(mask, p) != 0; }

// any lane's x, of any type of up to 64 bits (a double too)
template <class T>
T __shfl_sync(unsigned mask, T x, int src, int width = 32) {
  static_assert(sizeof(T) <= sizeof(uint64_t), "a shuffle moves at most 64 bits");
  uint64_t bits = 0, v[32];
  memcpy(&bits, &x, sizeof(T));
  emu_collect(mask, bits, v);
  const int lane = threadIdx.x & 31;
  T out;
  memcpy(&out, &v[(lane & ~(width - 1)) + (src & (width - 1))], sizeof(T));
  return out;
}

template <class T>
T __shfl_up_sync(unsigned mask, T x, unsigned d, int width = 32) {
  uint64_t v[32];
  emu_collect(mask, (uint32_t)x, v);
  const int lane = threadIdx.x & 31, src = lane - (int)d;
  return src < (lane & ~(width - 1)) ? x : (T)(uint32_t)v[src];
}

template <class T>
T __shfl_down_sync(unsigned mask, T x, unsigned d, int width = 32) {
  uint64_t v[32];
  emu_collect(mask, (uint32_t)x, v);
  const int lane = threadIdx.x & 31, src = lane + (int)d;
  return src >= (lane & ~(width - 1)) + width ? x : (T)(uint32_t)v[src];
}

template <class T>
T __shfl_xor_sync(unsigned mask, T x, int d, int width = 32) {
  uint64_t v[32];
  emu_collect(mask, (uint32_t)x, v);
  const int lane = threadIdx.x & 31, src = lane ^ d;
  return (src & ~(width - 1)) != (lane & ~(width - 1)) ? x : (T)(uint32_t)v[src];
}

inline unsigned __reduce_max_sync(unsigned mask, unsigned x) {
  uint64_t v[32];
  emu_collect(mask, x, v);
  unsigned most = 0;
  for (int k = 0; k < 32; ++k)
    if (mask >> k & 1u) most = std::max(most, (unsigned)v[k]);
  return most;
}

inline unsigned __reduce_add_sync(unsigned mask, unsigned x) {
  uint64_t v[32];
  emu_collect(mask, x, v);
  unsigned sum = 0;
  for (int k = 0; k < 32; ++k)
    if (mask >> k & 1u) sum += (unsigned)v[k];
  return sum;
}

inline void __syncwarp(unsigned mask = 0xFFFFFFFFu) {
  uint64_t v[32];
  emu_collect(mask, 0, v);
}

// a block-wide barrier; every thread of the block must reach it
inline void __syncthreads() {
  std::unique_lock<std::mutex> lock(emu_block->m);
  const unsigned long generation = emu_block->barrier_generation;
  if (++emu_block->barrier_arrived == (int)blockDim.x) {
    emu_block->barrier_arrived = 0;
    ++emu_block->barrier_generation;
    emu_block->barrier_cv.notify_all();
  } else {
    emu_block->barrier_cv.wait(lock, [&] { return emu_block->barrier_generation != generation; });
  }
}

// IEEE double operations rounded to nearest, never contracted (the host
// compiles without FMA contraction)
inline double __dadd_rn(double x, double y) { return x + y; }
inline double __dmul_rn(double x, double y) { return x * y; }
inline double __ddiv_rn(double x, double y) { return x / y; }

inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float x;
  memcpy(&x, &u, 4);
  return x;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int k = 0; k < 32; ++k) r |= (x >> k & 1u) << (31 - k);
  return r;
}
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
// 0xFF in each byte where x and y differ
inline unsigned __vcmpne4(unsigned x, unsigned y) {
  unsigned r = 0;
  for (int k = 0; k < 32; k += 8)
    if (((x ^ y) >> k) & 0xFFu) r |= 0xFFu << k;
  return r;
}
// Hopper's DPX forms: min(a + b, c), the sum wrapping in the lane's width
// (32 bits, or each signed 16-bit half); min(a, b, c) in each unsigned
// 16-bit half
inline int __viaddmin_s32(int a, int b, int c) {
  return std::min((int)((unsigned)a + (unsigned)b), c);
}
inline unsigned __viaddmin_s16x2(unsigned a, unsigned b, unsigned c) {
  unsigned r = 0;
  for (int k = 0; k < 32; k += 16) {
    const int16_t s = (int16_t)(uint16_t)((a >> k) + (b >> k));
    r |= (unsigned)(uint16_t)std::min(s, (int16_t)(uint16_t)(c >> k)) << k;
  }
  return r;
}
inline unsigned __vimin3_u16x2(unsigned a, unsigned b, unsigned c) {
  unsigned r = 0;
  for (int k = 0; k < 32; k += 16)
    r |= std::min({(a >> k) & 0xFFFFu, (b >> k) & 0xFFFFu, (c >> k) & 0xFFFFu}) << k;
  return r;
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __ffsll(unsigned long long x) { return x ? __builtin_ctzll(x) + 1 : 0; }
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned s) {
  s = s > 32 ? 32 : s;
  return (unsigned)(((((uint64_t)hi) << 32) | lo) << s >> 32);
}
template <class T>
T __ldg(const T* p) { return *p; }

// a shared- or global-memory atomic: the lanes are threads of one process
inline unsigned atomicAdd(unsigned* p, unsigned v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

inline unsigned char* emu_smem() { return emu_block->smem; }

// kernel<<<grid, threads, smem_bytes, stream>>>(...) becomes
// emu_launch(grid, threads, smem_bytes, stream, kernel, [&] { kernel(...); });
// shared memory starts as 0xAB bytes, so a read of what was never written
// shows up as a wrong result.
template <class K, class F>
void emu_launch(int grid, int threads, int smem_bytes, void*, K kernel_fn, F kernel) {
  if (smem_bytes > 48 * 1024) {
    const auto limit = emu_dynamic_smem_limit.find({emu_device, (const void*)kernel_fn});
    if (limit == emu_dynamic_smem_limit.end() || limit->second < smem_bytes) {
      emu_last_error = cudaErrorInvalidValue;
      return;
    }
  }
  for (int bx = 0; bx < grid; ++bx) {
    EmuBlock block;
    for (auto& e : block.exited) e = 0u;
    emu_block = &block;
    std::vector<unsigned char> smem(smem_bytes + 16, 0xAB);
    block.smem = smem.data() + (16 - ((uintptr_t)smem.data() & 15)) % 16;
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t)
      lanes.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = bx;
        blockDim.x = threads;
        gridDim.x = grid;
        kernel();
        block.exited[t >> 5] |= 1u << (t & 31);
      });
    for (auto& lane : lanes) lane.join();
  }
}
