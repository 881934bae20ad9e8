// Bigram multiset intersection with the positional-match and row-equality
// stats, a group of lanes per row pair, widths <= 64.
//
// Replaces strsim_tpu/ops/bigram_pallas.py: _kernel behind
// bigram_stats_pallas, which the JAX engine takes for the bigram measures at
// widths <= 63 and whose ham_m and eq outputs serve hamming and the bigram
// finalizers' equality patch (strsim_tpu/ops/stats.py:535-558). Same integer
// contract as the plain torch version in strsim_tpu_torch/ops/bigram_cuda.py:
//   inter2  sum over bigrams g of min(cnt_a(g), cnt_b(g)): bigram i < la - 1
//           of a counts iff its occurrence rank among equal bigrams of a is
//           below its count among the lb - 1 bigrams of b;
//   ham_m   sum over the whole width of (a_i == b_i);
//   eq      (la == lb) & (ham_m == la).
// A side with fewer than 2 chars gives inter2 = 0.
//
// What bounds it on this card: per row and bigram of a, its equality word
// over b's bigram starts (lb - 1 compares if built naively) and a few word
// operations; rows are at most 2 x 64 chars, so issue rate and latency bound
// it, not memory bandwidth.
//
// The design (lanes.cuh, as K5 in lev_jaro_fused.cu): a group of G lanes per
// row pair, G = 1 at widths <= 32 and 2 above, lane w holding word w
// (b-positions 32w .. 32w + 31). A warp stages its rows in shared memory once
// with coalesced loads. EqB(c) (bit j = b_j == c, j < lb) comes as in K5:
// one read of a per-row table of b on int8 rows wider than 16 chars, 8, 16
// or 32 register compares on narrower int8 rows and on int32 tiles.
// Bigram i of a has the equality word over b's bigram starts
//   E_i = EqB(a_i) & (EqB(a_i+1) >> 1)
// across the row's words (lane 0 takes bit 0 of lane 1's word into its bit
// 31): bit j is set iff b_j == a_i and b_j+1 == a_i+1. The table holds only
// j < lb, so bit j of E_i is set only for j < lb - 1: pads need no test and
// no token. a's words are read in order, so each EqB(a_k) is read once and
// serves two bigrams. inter2 by greedy consumption, as K5's inter: bigram i
// counts iff E_i & ~taken has a bit, and the group's first such bit is
// taken. Each b-position starts one bigram, so the bits that different
// bigrams take never overlap, and the bits of E_i already taken are those
// the earlier counted occurrences of the same bigram took, min(rank, cnt_b)
// of them: the rank rule of the contract. ham_m: each lane compares its own
// 32 positions of the width from the staged rows, summed over the group.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxWords = 2;

// Blocks an SM holds: 3 with the int8 table (69..74 KB a block); without it
// six, which leave 85 registers a thread.
template <typename T, int N>
constexpr int kBlocksPerSm = lane_table<T, N> ? 3 : 6;

template <typename T, int G, int N>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<T, N>)
    bigram_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                  long long stride_b, const int* __restrict__ len_a,
                  const int* __restrict__ len_b, int* __restrict__ inter_out,
                  int* __restrict__ ham_out, int* __restrict__ eq_out, int n, int L,
                  bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRows = kWarp / G;
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kRows;
  if (r0 >= n) return;
  const int rows = (int)min((long long)kRows, (long long)n - r0);
  unsigned char* wsm = smem + (size_t)warp * lane_warp_bytes<T, G, N>(L);
  uint32_t* table_words = reinterpret_cast<uint32_t*>(wsm);
  if constexpr (lane_table<T, N>) clear_table(table_words, wl);
  const T* staged = stage_rows<T>(wsm + (lane_table<T, N> ? kTableBytes : 0), a, b, stride_a,
                                  stride_b, r0, rows, L, packed, wl);
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
  const int ga = min(max(la, 0), L) - 1;  // a's bigrams: one step each
  const int nb = min(max(lb, 0), L);
  const int base = 32 * g.lane;  // b-positions of this lane's word
  const int own = min(max(nb - base, 0), 32);
  const int steps = g.warp_max(ga);

  uint32_t taken = 0u;
  int inter = 0;
  const LaneEq<T, N> eq(table_words, wl, sb + base, own);
  const int last = max(ga, 0);  // a's last char
  uint32_t e_lo = eq(sa[0]);               // EqB(a_i)
  uint32_t e_hi = eq(sa[min(1, last)]);    // EqB(a_i+1)
  for (int i = 0; i < steps; ++i) {
    const uint32_t e_next = eq(sa[min(i + 2, last)]);  // the next step's word, read ahead
    const uint32_t e2 = e_lo & ((e_hi >> 1) | (g.from_above(e_hi, 0u) << 31));
    if (take_first(g, (G == 1 || i < ga) ? e2 & ~taken : 0u, taken)) ++inter;
    e_lo = e_hi;
    e_hi = e_next;
  }

  int ham = 0;  // over the whole width: pads differ per side
  for (int p = base; p < min(base + 32, L); ++p) ham += sa[p] == sb[p] ? 1 : 0;
  ham = g.sum(ham);
  if (live && g.lane == 0) {
    inter_out[r] = inter;
    ham_out[r] = ham;
    eq_out[r] = (la == lb && ham == la) ? 1 : 0;
  }
}

template <typename T, int G, int N>
cudaError_t launch_g(const T* a, const T* b, long long sa, long long sb, const int* la,
                     const int* lb, int* inter, int* ham, int* eq, int n, int L,
                     cudaStream_t stream) {
  const int rows_per_block = kWarps * (kWarp / G);
  const int smem = kWarps * lane_warp_bytes<T, G, N>(L);
  const auto kernel = bigram_kernel<T, G, N>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  kernel<<<(n + rows_per_block - 1) / rows_per_block, kThreads, smem, stream>>>(
      a, b, sa, sb, la, lb, inter, ham, eq, n, L, packed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int words, const void* a, const void* b, long long sa, long long sb,
                   const int* la, const int* lb, int* inter, int* ham, int* eq, int n, int L,
                   cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (words == 2) return launch_g<T, 2, 32>(ta, tb, sa, sb, la, lb, inter, ham, eq, n, L, stream);
  switch (lane_chars(L)) {
    case 8: return launch_g<T, 1, 8>(ta, tb, sa, sb, la, lb, inter, ham, eq, n, L, stream);
    case 16: return launch_g<T, 1, 16>(ta, tb, sa, sb, la, lb, inter, ham, eq, n, L, stream);
    default: return launch_g<T, 1, 32>(ta, tb, sa, sb, la, lb, inter, ham, eq, n, L, stream);
  }
}

}  // namespace
}  // namespace strsim

// Row r of a starts at a + r * stride_a elements (likewise b), so a and b may
// be column slices of one packed [n, 2L] tile. elem_bytes: 1 (int8) or 4
// (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_bigram(const void* a, const void* b, long long stride_a,
                             long long stride_b, const void* len_a,
                             const void* len_b, void* inter_out, void* ham_out,
                             void* eq_out, int n, int L, int elem_bytes,
                             void* stream) {
  const int words = (L + 31) / 32;
  if (n <= 0 || L <= 0 || words > strsim::kMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* inter = static_cast<int*>(inter_out);
  int* ham = static_cast<int*>(ham_out);
  int* eq = static_cast<int*>(eq_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)strsim::launch<int8_t>(words, a, b, stride_a, stride_b, la, lb, inter, ham, eq,
                                       n, L, s);
  if (elem_bytes == 4)
    return (int)strsim::launch<int32_t>(words, a, b, stride_a, stride_b, la, lb, inter, ham,
                                        eq, n, L, s);
  return (int)cudaErrorInvalidValue;
}
