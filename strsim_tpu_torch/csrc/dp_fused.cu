// Fused bit-parallel DP: lev_d, osa_d and lcs_len in any subset of two or
// more, or lcs_len alone, from one equality word per text char, a group of
// lanes per row pair, widths <= 512.
//
// Replaces strsim_tpu/ops/dp_fused_pallas.py: _kernel (L <= 63) and
// _kernel_wide (L <= 512), both behind dp_fused_stats_pallas, which the JAX
// engine takes when at least two of {lev, osa, lcs} are requested (lev only if
// the shared-equality kernel did not already give it), or lcs alone
// (strsim_tpu/ops/stats.py:380-417). Same integer contract, row for row, as the
// plain torch version in strsim_tpu_torch/ops/dp_fused_cuda.py, which runs the
// separate plain versions. lev alone is K1's (levenshtein_myers.cu) and osa
// alone K7's (osa_scan.cu): the same kernel, launched through their own entry
// points, so this library leaves those two subsets out.
//
// What bounds it on this card: the word operations of each requested
// recurrence per word and text char (Myers 17, OSA 21, LCS 4) plus the Eq
// word; issue rate and latency, not bandwidth.
//
// What the design does about it: it launches the scan kernel of dp_scan.cuh,
// which reads or builds each Eq word once per text char and hands it to each
// requested recurrence (the separate kernels would do it three times). One
// word a lane in a group of lanes per row keeps the live state at 7
// registers a lane with all three recurrences, where one thread a row held
// 7 x 16 words; only the requested recurrences' state is live.
#include "dp_scan.cuh"

// Row r of a starts at a + r * stride_a elements (likewise b). elem_bytes:
// 1 (int8) or 4 (int32). A null output pointer leaves its recurrence out; the
// pointers given must name two or more recurrences, or LCS alone. Returns the
// launch's cudaError_t.
extern "C" int strsim_dp_fused(const void* a, const void* b, long long stride_a,
                               long long stride_b, const void* len_a,
                               const void* len_b, void* lev_out, void* osa_out,
                               void* lcs_out, int n, int L, int elem_bytes,
                               void* stream) {
  const int flags = (lev_out != nullptr) | (osa_out != nullptr) << 1 | (lcs_out != nullptr) << 2;
  switch (flags) {
#define STRSIM_CASE(F, L_, O_, C_)                                                \
  case F:                                                                         \
    return strsim::launch_dp_scan<L_, O_, C_>(a, b, stride_a, stride_b, len_a,    \
                                              len_b, lev_out, osa_out, lcs_out, n, \
                                              L, elem_bytes, stream);
    STRSIM_CASE(3, true, true, false)
    STRSIM_CASE(4, false, false, true)
    STRSIM_CASE(5, true, false, true)
    STRSIM_CASE(6, false, true, true)
    STRSIM_CASE(7, true, true, true)
#undef STRSIM_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
