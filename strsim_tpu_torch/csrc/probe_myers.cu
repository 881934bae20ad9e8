// Three A/B probes of the Myers scan K1 (levenshtein_myers.cu) at one word
// a row (L <= 32), K16-K18, a thread a row.
//
// Replaces the TPU probes of tools/ (each file's kernel and wrapper):
//   K16 ab_myers_pallas.py _scan_kernel :92 (launched at :197), both loop
//       forms: eq_scan_kernel<0> (the fori_loop) and eq_scan_kernel<L> (the
//       static steps)
//   K17 ab_myers_pallas.py _ineq_kernel :113 (launched at :175): ineq_kernel
//   K18 ab_myers_swar.py _kernel_swar :54 (launched at :133): swar_kernel
// Contract of the probes, as strsim_tpu_torch/probes/myers.py's plain
// versions: pattern a, text b; pv all ones, mv 0, the score from la, moved
// by bit max(la - 1, 0) % 32 of Ph and Mh at every step j < min(lb, L).
// The equality word of step j has bit i = (a_i == b_j) over a padded with
// PAD_A (-1) to 32 chars (K16 reads it, K17 builds it the same way); K18's
// has bit i < 4 ceil(L / 4) from the byte compares, fill bytes 0xFF.
//
// What bounds them on this card: at one word a row the Myers step is about
// 17 integer operations, and the equality word costs more than that when it
// is built by compares (K17: 32 compares and 32 ORs a step; K18: about 5
// operations for each of ceil(L / 4) words). K16 reads a word of 4 bytes a
// step from device memory instead: at w31 that is 124 bytes a row against
// 62 chars, still far below the memory rate, so K16 is bound by its
// operations and by the latency of its loads.
//
// The design: one thread a row, 128 threads a block; the state (pv, mv, the
// score) lives in registers.
//   * K16 reads eq[j * n + row], so a warp's 32 loads of a step are one
//     coalesced 128-byte line. The scan form loops to the row's own trip
//     count; the unrolled form, built for every L in 1..32, runs all L steps
//     with the update kept where j < lb, so that every load may issue ahead
//     of the chain (eq is [L, n]: each load is in bounds).
//   * K17 and K18 stage the warp's 32 rows in shared memory once with
//     coalesced loads (lanes.cuh:stage_rows), then each thread holds its
//     pattern in registers: K17 32 chars as the tiles hold them (int8 or
//     int32; the TPU widened int8 to int32 only because Mosaic refuses int8
//     blocks), K18 ceil(L / 4) words of four bytes (built for each word
//     count 1..8), each step comparing b_j with all of them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kPadA = -1;  // utils/encode.py:PAD_A
// Blocks an SM holds of K17 and K18, 64 registers a thread. Told only the
// block size, ptxas aimed at 16 blocks and spilled K17 on int32 and K18 at
// 1 and 3..6 words, at 40 registers.
constexpr int kStagedBlocksPerSm = 8;

// One Myers step at one word (ab_myers_pallas.py:_myers_step); returns the
// score's change at bit `hbit`.
__device__ __forceinline__ int myers_step(uint32_t eq, uint32_t& pv, uint32_t& mv, unsigned hbit) {
  const uint32_t xh = (((eq & pv) + pv) ^ pv) | eq;
  const uint32_t xv = eq | mv;
  const uint32_t ph = mv | ~(xh | pv);
  const uint32_t mh = pv & xh;
  const int delta = (int)((ph >> hbit) & 1u) - (int)((mh >> hbit) & 1u);
  const uint32_t ph_s = (ph << 1) | 1u;
  const uint32_t mh_s = mh << 1;
  pv = mh_s | ~(xv | ph_s);
  mv = ph_s & xv;
  return delta;
}

__device__ __forceinline__ unsigned tracked_bit(int la) { return (unsigned)max(la - 1, 0) & 31u; }

// --- K16: the equality words come in, [L, n] --------------------------------

// L = 0: the scan, a runtime trip count; L > 0: L steps unrolled
template <int L>
__global__ void __launch_bounds__(kThreads)
    eq_scan_kernel(const uint32_t* __restrict__ eq, const int* __restrict__ len_a,
                   const int* __restrict__ len_b, int* __restrict__ out, int n, int width) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const int la = len_a[r];
  const int nb = min(max(len_b[r], 0), width);
  const unsigned hbit = tracked_bit(la);
  uint32_t pv = 0xFFFFFFFFu, mv = 0u;
  int score = la;
  if constexpr (L > 0) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t e = __ldg(eq + (long long)j * n + r);
      uint32_t p = pv, m = mv;
      const int d = myers_step(e, p, m, hbit);
      if (j < nb) pv = p, mv = m, score += d;
    }
  } else {
    for (int j = 0; j < nb; ++j) score += myers_step(__ldg(eq + (long long)j * n + r), pv, mv, hbit);
  }
  out[r] = score;
}

template <int L>
cudaError_t launch_eq_scan(int width, const uint32_t* eq, const int* la, const int* lb, int* out,
                           int n, cudaStream_t stream) {
  if constexpr (L > kWarp) {
    return cudaErrorInvalidValue;
  } else {
    if (width != L)
      return launch_eq_scan<L + 1>(width, eq, la, lb, out, n, stream);
    const auto kernel = eq_scan_kernel<L>;
    kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(eq, la, lb, out, n, width);
    return cudaGetLastError();
  }
}

// --- K17 and K18: the warp's rows staged, the pattern in registers ----------

// The warp's rows [r0, r0 + 32) staged; this lane's row, or null past the
// last row.
template <typename T>
__device__ __forceinline__ const T* stage_warp(unsigned char* smem, const T* a, const T* b,
                                               long long sa, long long sb, int n, int L,
                                               bool packed, long long& r) {
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kWarp;
  if (r0 >= n) return nullptr;
  const int rows = (int)min((long long)kWarp, (long long)n - r0);
  const T* staged = stage_rows<T>(smem + (size_t)warp * stage_bytes<T>(kWarp, L), a, b, sa, sb,
                                  r0, rows, L, packed, wl);
  __syncwarp();
  r = r0 + wl;
  return wl < rows ? staged + 2LL * L * wl : nullptr;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kStagedBlocksPerSm)
    ineq_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                long long stride_b, const int* __restrict__ len_a, const int* __restrict__ len_b,
                int* __restrict__ out, int n, int L, bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long r;
  const T* sa = stage_warp<T>(smem, a, b, stride_a, stride_b, n, L, packed, r);
  if (sa == nullptr) return;
  const T* sb = sa + L;
  int pat[kWarp];  // a padded with PAD_A to 32 chars
#pragma unroll
  for (int i = 0; i < kWarp; ++i) pat[i] = i < L ? (int)sa[i] : kPadA;
  const int la = len_a[r];
  const int nb = min(max(len_b[r], 0), L);
  const unsigned hbit = tracked_bit(la);
  uint32_t pv = 0xFFFFFFFFu, mv = 0u;
  int score = la;
  for (int j = 0; j < nb; ++j) {
    const int c = sb[j];
    uint32_t e = 0u;
#pragma unroll
    for (int i = 0; i < kWarp; ++i) e |= (uint32_t)(pat[i] == c) << i;
    score += myers_step(e, pv, mv, hbit);
  }
  out[r] = score;
}

// ab_myers_swar.py's byte-parallel compare: bit k of the nibble is set when
// byte k of x is zero (the exact zero-byte test; (x - 0x01010101) & ~x
// false-positives on 0x01 bytes under a borrow), the four high bits gathered
// by one multiply whose partial products meet in bits 28..31 without carries.
__device__ __forceinline__ uint32_t zero_byte_nibble(uint32_t x) {
  const uint32_t t = ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
  return (t * 0x00204081u) >> 28;
}

template <int W4>  // ceil(L / 4) words of a's bytes
__global__ void __launch_bounds__(kThreads, kStagedBlocksPerSm)
    swar_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, long long stride_a,
                long long stride_b, const int* __restrict__ len_a, const int* __restrict__ len_b,
                int* __restrict__ out, int n, int L, bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long r;
  const int8_t* sa = stage_warp<int8_t>(smem, a, b, stride_a, stride_b, n, L, packed, r);
  if (sa == nullptr) return;
  const int8_t* sb = sa + L;
  uint32_t ap[W4];  // four pattern bytes a word, fill bytes 0xFF past L
#pragma unroll
  for (int k = 0; k < W4; ++k) {
    uint32_t w = 0u;
#pragma unroll
    for (int byte = 0; byte < 4; ++byte) {
      const int i = 4 * k + byte;
      w |= (i < L ? (uint32_t)(uint8_t)sa[i] : 0xFFu) << (8 * byte);
    }
    ap[k] = w;
  }
  const int la = len_a[r];
  const int nb = min(max(len_b[r], 0), L);
  const unsigned hbit = tracked_bit(la);
  uint32_t pv = 0xFFFFFFFFu, mv = 0u;
  int score = la;
  for (int j = 0; j < nb; ++j) {
    const uint32_t bb = (uint32_t)(uint8_t)sb[j] * 0x01010101u;
    uint32_t e = 0u;
#pragma unroll
    for (int k = 0; k < W4; ++k) e |= zero_byte_nibble(ap[k] ^ bb) << (4 * k);
    score += myers_step(e, pv, mv, hbit);
  }
  out[r] = score;
}

template <typename K, typename T>
cudaError_t launch_staged(K kernel, const T* a, const T* b, long long sa, long long sb,
                          const int* la, const int* lb, int* out, int n, int L,
                          cudaStream_t stream) {
  const int smem = kWarps * stage_bytes<T>(kWarp, L);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(a, b, sa, sb, la, lb, out, n, L,
                                                                    packed);
  return cudaGetLastError();
}

template <int W4>
cudaError_t launch_swar(int words, const int8_t* a, const int8_t* b, long long sa, long long sb,
                        const int* la, const int* lb, int* out, int n, int L,
                        cudaStream_t stream) {
  if constexpr (W4 > kWarp / 4) {
    return cudaErrorInvalidValue;
  } else {
    if (words != W4) return launch_swar<W4 + 1>(words, a, b, sa, sb, la, lb, out, n, L, stream);
    return launch_staged(swar_kernel<W4>, a, b, sa, sb, la, lb, out, n, L, stream);
  }
}

}  // namespace
}  // namespace strsim

// K16. eq: [L, n] int32 words, row r's word of step j at eq[j * n + r];
// unroll: 0 the scan, 1 the unrolled steps. Returns the launch's
// cudaError_t (0 on success).
extern "C" int strsim_probe_myers_eq_scan(const void* eq, const void* len_a, const void* len_b,
                                          void* out, int n, int L, int unroll, void* stream) {
  using namespace strsim;
  if (n <= 0 || L <= 0 || L > kWarp) return (int)cudaErrorInvalidValue;
  const uint32_t* e = static_cast<const uint32_t*>(eq);
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (unroll) return (int)launch_eq_scan<1>(L, e, la, lb, o, n, s);
  const auto kernel = eq_scan_kernel<0>;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(e, la, lb, o, n, L);
  return (int)cudaGetLastError();
}

// K17. Row r of a starts at a + r * stride_a elements (likewise b), so a and
// b may be column slices of one packed [n, 2L] tile. elem_bytes: 1 (int8) or
// 4 (int32).
extern "C" int strsim_probe_myers_ineq(const void* a, const void* b, long long stride_a,
                                       long long stride_b, const void* len_a, const void* len_b,
                                       void* out, int n, int L, int elem_bytes, void* stream) {
  using namespace strsim;
  if (n <= 0 || L <= 0 || L > kWarp) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) {
    const int8_t* ta = static_cast<const int8_t*>(a);
    return (int)launch_staged(ineq_kernel<int8_t>, ta, static_cast<const int8_t*>(b), stride_a,
                              stride_b, la, lb, o, n, L, s);
  }
  if (elem_bytes == 4) {
    const int32_t* ta = static_cast<const int32_t*>(a);
    return (int)launch_staged(ineq_kernel<int32_t>, ta, static_cast<const int32_t*>(b), stride_a,
                              stride_b, la, lb, o, n, L, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K18, int8 tiles only; strides as K17's.
extern "C" int strsim_probe_myers_swar(const void* a, const void* b, long long stride_a,
                                       long long stride_b, const void* len_a, const void* len_b,
                                       void* out, int n, int L, void* stream) {
  using namespace strsim;
  if (n <= 0 || L <= 0 || L > kWarp) return (int)cudaErrorInvalidValue;
  return (int)launch_swar<1>((L + 3) / 4, static_cast<const int8_t*>(a),
                             static_cast<const int8_t*>(b), stride_a, stride_b,
                             static_cast<const int*>(len_a), static_cast<const int*>(len_b),
                             static_cast<int*>(out), n, L, static_cast<cudaStream_t>(stream));
}
