// Myers/Hyyro bit-parallel Levenshtein distance, a group of lanes per row
// pair.
//
// Replaces strsim_tpu/ops/levenshtein_pallas_scan.py: _kernel (W = 1),
// _kernel_multiword (W = 2) and _kernel_wide (W <= 16), all behind
// levenshtein_distance_myers_pallas. Same integer contract as the plain
// torch version in strsim_tpu_torch/ops/levenshtein_cuda.py:
//   pattern = a (bits i < len_a of Eq_j are a_i == b_j), text = b,
//   score starts at len_a, steps j < len_b, the score tracks bit len_a - 1,
//   the addition carry and the Ph/Mh shift-outs run from the low word up.
//
// What bounds it on this card: about 20 word operations per word and text
// char, plus the Eq word of each step; a row is at most 2 x 511 chars, so
// issue rate and latency bound it, not bandwidth.
//
// What the design does about it: it launches the scan kernel of dp_scan.cuh
// with Myers alone. A group of G lanes (the word count rounded up to a power
// of two) serves a row, one word a lane, so pv/mv are two registers a lane
// and the carry and shift-ins cross lanes by ballot and shuffle (lanes.cuh).
// The rows are staged in shared memory once; on int8 tiles a step's Eq word
// is one read of a per-row table, on int32 tiles 32 compares against the
// lane's own pattern chars in registers. Each group runs its own trip count
// len_b (the TPU kernel needed a per-block maximum as a scalar prefetch).
// int8 tiles are read as they are; the TPU widened them to int32 only
// because Mosaic refuses int8 blocks.
#include "dp_scan.cuh"

// Row r of a starts at a + r * stride_a elements (likewise b), so a and b may
// be column slices of one packed [n, 2L] tile. elem_bytes: 1 (int8) or 4
// (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_levenshtein_myers(const void* a, const void* b,
                                        long long stride_a, long long stride_b,
                                        const void* len_a, const void* len_b,
                                        void* out, int n, int L, int elem_bytes,
                                        void* stream) {
  return strsim::launch_dp_scan<true, false, false>(
      a, b, stride_a, stride_b, len_a, len_b, out, nullptr, nullptr, n, L,
      elem_bytes, stream);
}
