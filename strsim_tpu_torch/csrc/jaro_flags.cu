// K9: the jaro greedy match scan with its flags, a group of lanes per row
// pair.
//
// Replaces strsim_tpu/ops/jaro_pallas.py: _kernel, behind
// jaro_match_stats_pallas (only a forced jaro_impl="pallas" reaches it). Like
// that kernel it runs the greedy scan alone and writes the match count and
// both flag sets; the transposition count and the len-1/len-1 patch run
// outside it, in plain torch (strsim_tpu_torch/ops/jaro_flags_cuda.py), as
// the JAX wrapper runs them in XLA. Same integer contract as
// strsim_tpu_torch/ops/jaro_cuda.py:greedy_scan:
//   bound = max(la, lb) / 2 - 1 (may be -1); a-positions i < min(la, lb + bound)
//   each flag the first unflagged b-position j with b_j == a_i in
//   [max(i - bound, 0), min(i + bound, lb - 1)] and set matched_a[i]; m counts
//   them (0 on len-1/len-1 rows, whose window is empty).
//
// What bounds it on this card: K2's greedy chain (jaro_body.cuh), and the
// flag tensors, 2 * L bytes a row to write, the largest part of its bytes
// (65,536 rows at w511 write 67 MB).
//
// The design: K2's kernel (jaro_body.cuh) cut to kJaroFlags, the scan raw
// (no len-1/len-1 patch, no transposition count). Lane w of a row's group
// ends the scan holding word w of b's flag vector and of a's matched
// vector; the warp expands them to bytes in its shared memory and stores
// its rows' span of each [n, L] tensor with coalesced 16-byte stores, zeros
// past the lengths included (jaro_store_flags).
#include <cuda_runtime.h>
#include <stdint.h>

#include "jaro_body.cuh"

// Row r of a starts at a + r * stride_a elements (likewise b). matched_a and
// flagged_b are contiguous [n, L] arrays of 0/1 bytes (torch.bool), every
// byte written. elem_bytes: 1 (int8) or 4 (int32). One launch; returns its
// cudaError_t (0 on success).
extern "C" int strsim_jaro_flags(const void* a, const void* b,
                                 long long stride_a, long long stride_b,
                                 const void* len_a, const void* len_b,
                                 void* m_out, void* matched_a, void* flagged_b,
                                 int n, int L, int elem_bytes, void* stream) {
  using namespace strsim;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  JaroLaunch f{a, b, stride_a, stride_b, static_cast<const int*>(len_a),
               static_cast<const int*>(len_b), static_cast<int*>(m_out), nullptr, nullptr, n, L,
               static_cast<cudaStream_t>(stream)};
  f.matched = static_cast<uint8_t*>(matched_a);
  f.flagged = static_cast<uint8_t*>(flagged_b);
  return (int)jaro_select_elem<kJaroFlags, false>(elem_bytes, L, f);
}
