// A CPU stand-in for the CUDA runtime pieces that the lane-group kernels use
// (csrc/dp_scan.cuh, csrc/jaro_scan.cu), so that their logic runs where there
// is no card: tests/test_torch_lane_kernels_cpu.py compiles those sources
// with g++ against this header, as cuda_runtime.h. One std::thread per CUDA
// thread, the blocks of a launch in turn; every warp collective is a
// rendezvous of the lanes its mask names, and a collective that names a lane
// which has already returned aborts instead of hanging. Only what the kernels
// call is here; the test rewrites their launch syntax and their dynamic
// shared memory declaration before compiling.
#pragma once
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
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
using std::max;
using std::min;
inline long long min(long long a, long long b) { return a < b ? a : b; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
typedef void* cudaStream_t;
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// --- one block at a time ----------------------------------------------------

struct EmuRendezvous {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  unsigned long generation = 0;
  uint64_t filling[32], done[32];
};

struct EmuBlock {
  std::mutex m;
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
  const unsigned long generation = r.generation;
  if (++r.arrived == __builtin_popcount(mask)) {
    memcpy(r.done, r.filling, sizeof r.done);
    r.arrived = 0;
    ++r.generation;
    r.cv.notify_all();
  } else {
    while (!r.cv.wait_for(lock, std::chrono::milliseconds(50), [&] { return r.generation != generation; }))
      if (emu_block->exited[warp].load() & mask) emu_fail("collective names a lane that returned", warp, mask);
  }
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

template <class T>
T __shfl_up_sync(unsigned mask, T x, unsigned d, int width = 32) {
  uint64_t v[32];
  emu_collect(mask, (uint32_t)x, v);
  const int lane = threadIdx.x & 31, src = lane - (int)d;
  return src < (lane & ~(width - 1)) ? x : (T)(uint32_t)v[src];
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

inline void __syncwarp(unsigned mask = 0xFFFFFFFFu) {
  uint64_t v[32];
  emu_collect(mask, 0, v);
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline unsigned __funnelshift_lc(unsigned lo, unsigned hi, unsigned s) {
  s = s > 32 ? 32 : s;
  return (unsigned)(((((uint64_t)hi) << 32) | lo) << s >> 32);
}
template <class T>
T __ldg(const T* p) { return *p; }

inline unsigned char* emu_smem() { return emu_block->smem; }

// kernel<<<grid, threads, smem_bytes, stream>>>(...) becomes
// emu_launch(grid, threads, smem_bytes, stream, [&] { kernel(...); });
// shared memory starts as 0xAB bytes, so a read of what was never written
// shows up as a wrong result.
template <class F>
void emu_launch(int grid, int threads, int smem_bytes, void*, F kernel) {
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
        kernel();
        block.exited[t >> 5] |= 1u << (t & 31);
      });
    for (auto& lane : lanes) lane.join();
  }
}
