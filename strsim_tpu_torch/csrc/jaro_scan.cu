// K2: jaro match statistics (m, t) and, when asked, the common prefix, a
// group of lanes per row pair.
//
// Replaces strsim_tpu/ops/jaro_pallas_scan.py: _kernel (L <= 64) and
// _kernel_wide (L <= 512) with _count_unequal_slots, behind
// jaro_match_stats_pallas_scan, including the len-1/len-1 patch it applies
// after the kernel (:400-407), and the prefix of
// strsim_tpu/ops/stats.py:shared_prefix_length, which the TPU computed in
// XLA beside it. Same integer contract as the plain torch version in
// strsim_tpu_torch/ops/jaro_cuda.py:
//   bound = max(la, lb) / 2 - 1 (may be -1); a-positions i < min(la, lb + bound)
//   each flag the first unflagged b-position j with b_j == a_i in
//   [max(i - bound, 0), min(i + bound, lb - 1)]; m counts them; t counts the
//   ranks r where the r-th matched a char differs from the r-th flagged b
//   char (the reference's ordered zip, strsim.rs:220-237); la == lb == 1
//   gives m = (a_0 == b_0), t = 0 (strsim.rs:197-199); prefix is the common
//   prefix of the tiles' rows capped at min(L, 4) (strsim.rs:261-266; the
//   pads differ per side, so no length mask).
//
// What bounds it on this card, and the design: jaro_body.cuh, whose kernel
// this file builds in full (K15 in probe_jaro.cu builds its cuts).
#include <cuda_runtime.h>
#include <stdint.h>

#include "jaro_body.cuh"

namespace strsim {
namespace {

// What an instantiation gets from the card, at width L: blocks an SM holds
// (the occupancy calculator at the launch's dynamic shared memory, after the
// launch's own attributes), registers and local memory bytes a thread, and
// the launch's dynamic shared memory.
struct JaroResidency {
  int L;
  int* out;

  template <typename T, int G, int N, bool kTable, int Cut, bool kPrefix>
  cudaError_t run() const {
    const auto kernel = jaro_kernel<T, G, N, kTable, Cut, kPrefix>;
    const int smem = kJaroWarps * jaro_warp_bytes<T, G, kTable>(L);
    cudaError_t err =
        jaro_configure(kernel, kJaroWarps * jaro_warp_bytes<T, G, kTable>(jaro_max_width<G, N>));
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    out[3] = smem;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kJaroThreads, smem);
  }
};

}  // namespace
}  // namespace strsim

// Row r of a starts at a + r * stride_a elements (likewise b). elem_bytes:
// 1 (int8) or 4 (int32). prefix_out may be null: the prefix is then left
// out. One launch; returns its cudaError_t (0 on success).
extern "C" int strsim_jaro_scan(const void* a, const void* b,
                                long long stride_a, long long stride_b,
                                const void* len_a, const void* len_b,
                                void* m_out, void* t_out, void* prefix_out, int n, int L,
                                int elem_bytes, void* stream) {
  using namespace strsim;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const JaroLaunch f{a, b, stride_a, stride_b, static_cast<const int*>(len_a),
                     static_cast<const int*>(len_b), static_cast<int*>(m_out),
                     static_cast<int*>(t_out), static_cast<int*>(prefix_out), n, L,
                     static_cast<cudaStream_t>(stream)};
  if (prefix_out != nullptr) return (int)jaro_select_elem<kJaroK2, true>(elem_bytes, L, f);
  return (int)jaro_select_elem<kJaroK2, false>(elem_bytes, L, f);
}

// The launch's residency at width L, with or without the prefix: out[0..3]
// = blocks an SM holds, registers a thread, local memory bytes a thread,
// dynamic shared memory bytes a block.
extern "C" int strsim_jaro_scan_residency(int L, int elem_bytes, int with_prefix, void* out) {
  using namespace strsim;
  const JaroResidency f{L, static_cast<int*>(out)};
  if (with_prefix) return (int)jaro_select_elem<kJaroK2, true>(elem_bytes, L, f);
  return (int)jaro_select_elem<kJaroK2, false>(elem_bytes, L, f);
}
