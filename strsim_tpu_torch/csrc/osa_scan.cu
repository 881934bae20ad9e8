// OSA (restricted Damerau-Levenshtein) distance, Hyyro's bit-parallel D0
// formulation, a group of lanes per row pair, widths <= 512.
//
// Replaces strsim_tpu/ops/osa_pallas_scan.py: _kernel (W = 1),
// _kernel_multiword (W = 2) and _kernel_wide (W <= 16), all behind
// osa_distance_pallas, which the JAX engine takes for osa when no fused
// kernel carries it (strsim_tpu/ops/stats.py:567-581). Same integer contract
// as the plain torch version in strsim_tpu_torch/ops/osa_cuda.py: pattern a,
// text b, for each text char b_j (j < lb) with Eq words PM and the previous
// step's D0' and PM' (zero before the first step):
//   TR = (((~D0') & PM) << 1) & PM'
//   D0 = (((PM & PV) + PV) ^ PV) | PM | MV | TR
//   HP = MV | ~(D0 | PV); HN = D0 & PV; score += HP - HN at bit la - 1
//   PV = (HN << 1) | ~(D0 | (HP << 1 | 1)); MV = (HP << 1 | 1) & D0
// from PV = all ones, MV = 0, score = la. TR enters D0 before HP/HN are
// derived from it; each of the three left shifts carries bit 31 of word w
// into word w + 1 (lanes.cuh: osa_lane).
//
// What bounds it on this card: about 21 word operations per word and text
// char plus the Eq word; issue rate and latency, not bandwidth.
//
// What the design does about it: it launches the scan kernel of dp_scan.cuh
// with OSA alone, the instantiation K6 would run for osa_d alone. A group of
// lanes serves a row, one word a lane, so PV, MV, D0' and PM' are four
// registers a lane; TR's, HP's and HN's shift-ins come from the lane below
// by shuffle and the addition carry by ballot (lanes.cuh). The Eq word is a
// table read on int8 tiles and the lane's own 32 compares on int32 tiles,
// from rows staged in shared memory once; each group runs its own trip count
// lb (the TPU kernel needed a per-block maximum by scalar prefetch).
#include "dp_scan.cuh"

// Row r of a starts at a + r * stride_a elements (likewise b). elem_bytes:
// 1 (int8) or 4 (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_osa_distance(const void* a, const void* b,
                                   long long stride_a, long long stride_b,
                                   const void* len_a, const void* len_b,
                                   void* out, int n, int L, int elem_bytes,
                                   void* stream) {
  return strsim::launch_dp_scan<false, true, false>(
      a, b, stride_a, stride_b, len_a, len_b, nullptr, out, nullptr, n, L,
      elem_bytes, stream);
}
