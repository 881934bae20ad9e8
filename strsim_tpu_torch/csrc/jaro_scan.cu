// Jaro match statistics (m, t), a group of lanes per row pair.
//
// Replaces strsim_tpu/ops/jaro_pallas_scan.py: _kernel (L <= 64) and
// _kernel_wide (L <= 512) with _count_unequal_slots, behind
// jaro_match_stats_pallas_scan, including the len-1/len-1 patch it applies
// after the kernel (:400-407). Same integer contract as the plain torch
// version in strsim_tpu_torch/ops/jaro_cuda.py:
//   bound = max(la, lb) / 2 - 1 (may be -1); a-positions i < min(la, lb + bound)
//   each flag the first unflagged b-position j with b_j == a_i in
//   [max(i - bound, 0), min(i + bound, lb - 1)]; m counts them; t counts the
//   ranks r where the r-th matched a char differs from the r-th flagged b
//   char (the reference's ordered zip, strsim.rs:220-237); la == lb == 1
//   gives m = (a_0 == b_0), t = 0 (strsim.rs:197-199).
//
// What bounds it on this card: per a-position, finding b's window
// candidates (up to 2 * bound + 1 compares if done naively) and a few word
// operations per word of the window; rows are at most 2 x 511 chars, so
// issue rate and latency bound it, not memory bandwidth.
//
// The design (lanes.cuh, as the scan kernel of dp_scan.cuh): a group of G
// lanes per row pair, G the word count rounded up to a power of two; lane w
// holds word w of b's flag vector and of a's matched vector. A warp stages
// its rows once with coalesced loads. b's equality word for a_i is one
// shared-memory read on int8 tiles, from a per-row table each lane fills
// from its own 32 b chars; on int32 tiles the lane compares a_i with its 32
// b chars in registers. One greedy step per a-position, the same on every
// lane: candidates = Eq & window & ~flag, the group ballot names the first
// lane with one, that lane flags its lowest candidate bit, and m and a's
// matched bit follow from the ballot (a ballot over the whole warp, whose
// loop runs to its longest row, as in the scan kernel). t: each lane's
// popcounts, scanned over
// the group, give the ranks; the lanes write their matched a chars and
// flagged b chars in rank order to shared memory and compare them in
// parallel. Chars are compared as they are, exact for every codepoint,
// astral ones included, on int8 and int32 tiles alike.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxWords = 16;

// shared memory of one warp: the int8 equality table (reused for the rank
// slots once the scan is done) or the int32 rank slots (none at G <= 2),
// then its staged rows
template <typename T, int G>
__host__ __device__ constexpr int warp_bytes(int L) {
  return (lane_table<T> ? kTableBytes : kRankSlotBytes<G>) + stage_bytes<T>(kWarp / G, L);
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
    jaro_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                long long stride_b, const int* __restrict__ len_a,
                const int* __restrict__ len_b, int* __restrict__ m_out,
                int* __restrict__ t_out, int n, int L, bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kTable = lane_table<T>;
  constexpr int kRows = kWarp / G;
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kRows;
  if (r0 >= n) return;
  const int rows = (int)min((long long)kRows, (long long)n - r0);
  unsigned char* wsm = smem + (size_t)warp * warp_bytes<T, G>(L);
  uint32_t* table_words = reinterpret_cast<uint32_t*>(wsm);
  if constexpr (kTable) clear_table(table_words, wl);
  const T* staged = stage_rows<T>(wsm + (kTable ? kTableBytes : kRankSlotBytes<G>), a, b,
                                  stride_a, stride_b, r0, rows, L, packed, wl);
  __syncwarp();

  // every lane stays to the end: the collectives take the whole warp; a
  // group past the last row runs no step and writes nothing
  const LaneGroup<G> g;
  const int k = wl / G;  // the group's row in the warp
  const bool live = k < rows;
  const long long r = r0 + (live ? k : 0);
  const T* sa = staged + 2LL * L * (live ? k : 0);
  const T* sb = sa + L;
  const int la = live ? len_a[r] : 0;
  const int lb = live ? len_b[r] : 0;
  const bool one_one = la == 1 && lb == 1;  // compared directly below
  const int bound = max(la, lb) / 2 - 1;
  const int i_end = one_one ? 0 : max(min(min(la, lb + bound), L), 0);
  const int nb = min(max(lb, 0), L);
  const int base = 32 * g.lane;  // b- and a-positions of this lane's word
  const T* mine = sb + base;
  const int own = min(max(nb - base, 0), 32);
  const int steps = g.warp_max(i_end);

  uint32_t flag = 0u, mat = 0u;
  int m = 0;
  const LaneEq<T> eq(table_words, wl, mine, own);
  uint32_t e_next = eq(sa[0]);
  for (int i = 0; i < steps; ++i) {
    const uint32_t e = e_next;
    e_next = eq(sa[max(min(i + 1, i_end - 1), 0)]);  // the next step's word, read ahead
    const int lo = max(i - bound, 0) - base;
    const int hi = min(i + bound, nb - 1) - base;
    const uint32_t cand = (G == 1 || i < i_end)
                              ? e & ones_from(lo) & ~ones_from(hi + 1) & ~flag : 0u;
    if (take_first(g, cand, flag)) {  // the first match
      if (g.lane == (i >> 5)) mat |= 1u << (i & 31);
      ++m;
    }
  }

  g.sync();  // the table's last reads are done: the rank slots overlay it
  const int t = jaro_transpositions(g, table_words, sa, sb, mat, flag, m);
  if (live && g.lane == 0) {
    m_out[r] = one_one ? (sa[0] == sb[0] ? 1 : 0) : m;
    t_out[r] = t;
  }
}

template <typename T, int G>
cudaError_t launch_g(const T* a, const T* b, long long sa, long long sb, const int* la,
                     const int* lb, int* m, int* t, int n, int L, cudaStream_t stream) {
  const int rows_per_block = kWarps * (kWarp / G);
  const int smem = kWarps * warp_bytes<T, G>(L);
  const auto kernel = jaro_kernel<T, G>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  kernel<<<(n + rows_per_block - 1) / rows_per_block, kThreads, smem, stream>>>(
      a, b, sa, sb, la, lb, m, t, n, L, packed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int words, const void* a, const void* b, long long sa, long long sb,
                   const int* la, const int* lb, int* m, int* t, int n, int L,
                   cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  switch (group_lanes(words)) {
    case 1: return launch_g<T, 1>(ta, tb, sa, sb, la, lb, m, t, n, L, stream);
    case 2: return launch_g<T, 2>(ta, tb, sa, sb, la, lb, m, t, n, L, stream);
    case 4: return launch_g<T, 4>(ta, tb, sa, sb, la, lb, m, t, n, L, stream);
    case 8: return launch_g<T, 8>(ta, tb, sa, sb, la, lb, m, t, n, L, stream);
    default: return launch_g<T, 16>(ta, tb, sa, sb, la, lb, m, t, n, L, stream);
  }
}

}  // namespace
}  // namespace strsim

// Row r of a starts at a + r * stride_a elements (likewise b). elem_bytes:
// 1 (int8) or 4 (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_jaro_scan(const void* a, const void* b,
                                long long stride_a, long long stride_b,
                                const void* len_a, const void* len_b,
                                void* m_out, void* t_out, int n, int L,
                                int elem_bytes, void* stream) {
  const int words = (L + 31) / 32;
  if (n <= 0 || L <= 0 || words > strsim::kMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* m = static_cast<int*>(m_out);
  int* t = static_cast<int*>(t_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)strsim::launch<int8_t>(words, a, b, stride_a, stride_b, la, lb, m, t, n, L, s);
  if (elem_bytes == 4)
    return (int)strsim::launch<int32_t>(words, a, b, stride_a, stride_b, la, lb, m, t, n, L, s);
  return (int)cudaErrorInvalidValue;
}
