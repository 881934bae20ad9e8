// Character-multiset intersection sum_c min(cnt_a(c), cnt_b(c)) per row pair,
// in two forms. Both match the plain torch versions in
// strsim_tpu_torch/ops/multiset_cuda.py (rank_plain, hist_plain) on every row;
// both read lengths, so padded rows (la = lb = 0) give 0.
//
// strsim_multiset_rank (K3) replaces strsim_tpu/ops/multiset_pallas.py:_kernel
// (behind multiset_intersection_pallas, widths <= 64), any codepoint, int8 or
// int32: position i < la of a counts iff its occurrence rank among equal
// chars of a is below that char's count in b[:lb] (int8 chars below 0 inside
// the lengths count like any other).
//   What bounds it on this card: the bytes of both rows, read once (a few
//   MB for 65,536 rows); the work is one equality word and a few word
//   operations per a-position, far below the issue rate. A thread a row
//   walking a[0..i) and b for every i (the earlier form) spent its time on
//   one-byte loads that touch 32 rows each.
//   The design (lanes.cuh, as K5's inter in lev_jaro_fused.cu and K8's
//   bigram count in bigram.cu): a group of G lanes per row pair, G = 1 at
//   widths <= 32 and 2 above, lane w holding b-positions 32w .. 32w + 31; a
//   warp stages its rows once with coalesced 16-byte loads. EqB(c) (bit j =
//   b_j == c, j < lb) is one read of a per-row table of b on int8 rows wider
//   than 16 chars, 8, 16 or 32 register compares on narrower int8 rows and on
//   int32 tiles. One step per a-position, by greedy consumption: a_i counts
//   iff EqB(a_i) & ~taken has a bit, and the group's first such bit is taken
//   (take_first). Different chars own disjoint bits of b, so the bits of
//   EqB(a_i) already taken are those the earlier counted occurrences of a_i
//   took, min(rank, cnt_b(a_i)) of them: the rank rule. The table holds only
//   j < lb, so pads need no test.
//
// strsim_multiset_hist (K4) replaces multiset_pallas.py:_kernel_hist (behind
// multiset_intersection_hist): 8-bit tiles of widths up to 512, where chars
// below 0 (the pads among them) never count, on either side.
//   What bounds it on this card: the bytes of both rows, read once (67 MB
//   for 65,536 padded rows at w511, about 0.02 ms). A thread a row (the
//   earlier form) loaded its chars a byte at a time, 32 rows a load, cleared
//   128 bins one store at a time and ran la + lb dependent updates; 15 warps
//   an SM could not hide that.
//   The design, in two forms by width:
//   * rows wider than 47: 8 lanes a row, 4 rows a warp. The row's lanes
//     read its chars in place as 16-byte aligned chunks (coalesced: the
//     lanes take consecutive chunks; only chunks inside the lengths are
//     read, and their bytes outside are masked off) and count them with
//     shared-memory atomicAdd of 1 into two 128-bin tables a row, one for a
//     and one for b (both +1 increments, which compile to ATOMS.POPC.INC;
//     one packed a | b << 16 word made b's plain adds, no faster). Bin c of
//     the warp's row k sits at word c * 4 + k, so one char in different rows
//     of a warp falls in different banks. Each lane then sums min(a, b) over
//     its 16 bins and the row's lanes add their sums with shuffles. Staging
//     the chunks through shared memory first (stage_rows) was 0.64..0.88x
//     as fast, 4 or 16 lanes a row slower than 8 (PERF.md, section 6).
//   * rows of 47 chars or fewer (reached only under a forced "pallas_hist"),
//     where the 256 words of clearing and summing a row outweigh its chars:
//     a thread a row, as in the earlier form, but from rows staged once with
//     coalesced 16-byte loads (stage_rows), its bins a column of the warp's
//     16-bit table, clearing only the bins of its chars (not all 128), then
//     a's counts consumed by b's chars.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;

// --- K3: occurrence rank by greedy consumption ----------------------------

constexpr int kRankMaxWords = 2;

// Blocks an SM holds: 3 with the int8 table (69..74 KB a block); without it
// shared memory allows 7 or more, and 6 leave 85 registers a thread for
// int32 compares in registers.
template <typename T, int N>
constexpr int kRankBlocks = lane_table<T, N> ? 3 : 6;

template <typename T, int G, int N>
__global__ void __launch_bounds__(kThreads, kRankBlocks<T, N>)
    rank_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                long long stride_b, const int* __restrict__ len_a,
                const int* __restrict__ len_b, int* __restrict__ out, int n, int L,
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
  const int na = live ? min(max(len_a[r], 0), L) : 0;  // the a-positions: one step each
  const int nb = live ? min(max(len_b[r], 0), L) : 0;
  const int base = 32 * g.lane;  // b-positions of this lane's word
  const int steps = g.warp_max(na);

  uint32_t taken = 0u;
  int inter = 0;
  const LaneEq<T, N> eq(table_words, wl, sb + base, min(max(nb - base, 0), 32));
  uint32_t e_next = eq(sa[0]);
  for (int i = 0; i < steps; ++i) {
    const uint32_t e = e_next;
    e_next = eq(sa[max(min(i + 1, na - 1), 0)]);  // the next step's word, read ahead
    if (take_first(g, (G == 1 || i < na) ? e & ~taken : 0u, taken)) ++inter;
  }
  if (live && g.lane == 0) out[r] = inter;
}

template <typename T, int G, int N>
cudaError_t launch_rank_g(const T* a, const T* b, long long sa, long long sb, const int* la,
                          const int* lb, int* out, int n, int L, cudaStream_t stream) {
  const int rows_per_block = kWarps * (kWarp / G);
  const int smem = kWarps * lane_warp_bytes<T, G, N>(L);
  const auto kernel = rank_kernel<T, G, N>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  kernel<<<(n + rows_per_block - 1) / rows_per_block, kThreads, smem, stream>>>(
      a, b, sa, sb, la, lb, out, n, L, packed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rank(const void* a, const void* b, long long sa, long long sb, const int* la,
                        const int* lb, int* out, int n, int L, cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (L > 32) return launch_rank_g<T, 2, 32>(ta, tb, sa, sb, la, lb, out, n, L, stream);
  switch (lane_chars(L)) {
    case 8: return launch_rank_g<T, 1, 8>(ta, tb, sa, sb, la, lb, out, n, L, stream);
    case 16: return launch_rank_g<T, 1, 16>(ta, tb, sa, sb, la, lb, out, n, L, stream);
    default: return launch_rank_g<T, 1, 32>(ta, tb, sa, sb, la, lb, out, n, L, stream);
  }
}

// --- K4: a histogram a row -------------------------------------------------

constexpr int kHistMaxWidth = 512;
constexpr int kNarrowHist = 47;  // widths up to this: a thread a row (PERF.md, section 6)

// Narrow rows: a thread a row, its bins a column of the warp's 16-bit table
// (bin c of lane w at halfword c * 32 + w), then the warp's staged rows.
__host__ __device__ constexpr int narrow_warp_bytes(int L) {
  return kAscii * kWarp * 2 + stage_bytes<int8_t>(kWarp, L);
}

// Blocks an SM holds: shared memory allows 4 at w47 (45 KB a block), more
// below.
__global__ void __launch_bounds__(kThreads, 4)
    hist_narrow_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                       long long stride_a, long long stride_b, const int* __restrict__ len_a,
                       const int* __restrict__ len_b, int* __restrict__ out, int n, int L,
                       bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kWarp;
  if (r0 >= n) return;
  const int rows = (int)min((long long)kWarp, (long long)n - r0);
  unsigned char* wsm = smem + (size_t)warp * narrow_warp_bytes(L);
  const int8_t* staged = stage_rows<int8_t>(wsm + kAscii * kWarp * 2, a, b, stride_a, stride_b,
                                            r0, rows, L, packed, wl);
  __syncwarp();
  if (wl >= rows) return;  // nothing below takes the warp
  uint16_t* bins = reinterpret_cast<uint16_t*>(wsm) + wl;  // bin c at bins[c * kWarp]
  const int8_t* sa = staged + 2LL * L * wl;
  const int8_t* sb = sa + L;
  const int na = min(max(len_a[r0 + wl], 0), L);
  const int nb = min(max(len_b[r0 + wl], 0), L);
  for (int i = 0; i < na; ++i)  // clear only the bins the row reads
    if (sa[i] >= 0) bins[sa[i] * kWarp] = 0;
  for (int j = 0; j < nb; ++j)
    if (sb[j] >= 0) bins[sb[j] * kWarp] = 0;
  for (int i = 0; i < na; ++i)
    if (sa[i] >= 0) ++bins[sa[i] * kWarp];
  int inter = 0;
  for (int j = 0; j < nb; ++j) {  // b's chars consume a's counts
    if (sb[j] < 0) continue;
    uint16_t& v = bins[sb[j] * kWarp];
    if (v) --v, ++inter;
  }
  out[r0 + wl] = inter;
}

// Wide rows: kWideLanes lanes a row, so a warp takes kWideRows rows; in
// shared memory each warp holds its rows' bins of a, then those of b (bin c
// of the warp's row k at word c * kWideRows + k of each).
constexpr int kWideLanes = 8;
constexpr int kWideRows = kWarp / kWideLanes;
constexpr int kWideBins = kAscii * kWideRows;  // words of one side's bins a warp

// Adds 1 to bin c of `bins` (bin c at bins[c * kWideRows]) for each char
// c >= 0 of s[0 .. n): the lanes of a row take the 16-byte aligned chunks that
// hold the span in turn (lane, lane + kWideLanes, ...), one load each; the
// bytes of a chunk outside the span are masked off.
__device__ __forceinline__ void count_span(const int8_t* s, int n, uint32_t* bins, int lane) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(s) & 15);
  const uint4* chunks = reinterpret_cast<const uint4*>(s - mis);
  const int nq = (mis + n + 15) >> 4;
  for (int q = lane; q < nq; q += kWideLanes) {
    const uint4 v = chunks[q];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const int p0 = 16 * q - mis;  // the span position of the chunk's first byte
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int c = (int)(int8_t)(w[t >> 2] >> (8 * (t & 3)));
      if (c >= 0 && (unsigned)(p0 + t) < (unsigned)n) atomicAdd(bins + c * kWideRows, 1u);
    }
  }
}

// 16 KB of bins a block; registers (about 40 a thread) allow 12 blocks an SM,
// and 8 leave room for 64.
__global__ void __launch_bounds__(kThreads, 8)
    hist_wide_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                     long long stride_a, long long stride_b, const int* __restrict__ len_a,
                     const int* __restrict__ len_b, int* __restrict__ out, int n, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kWideRows;
  if (r0 >= n) return;
  uint32_t* table = reinterpret_cast<uint32_t*>(smem) + warp * 2 * kWideBins;
  uint4* t4 = reinterpret_cast<uint4*>(table);
  for (int q = wl; q < 2 * kWideBins / 4; q += kWarp) t4[q] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();

  // every lane stays to the end: the row sum takes the whole warp
  const int k = wl / kWideLanes, lane = wl % kWideLanes;  // the lane's row, its place in it
  const bool live = r0 + k < n;
  const long long r = live ? r0 + k : r0;
  const int na = live ? min(max(len_a[r], 0), L) : 0;
  const int nb = live ? min(max(len_b[r], 0), L) : 0;
  uint32_t* bins_a = table + k;  // bin c at bins_a[c * kWideRows]
  uint32_t* bins_b = bins_a + kWideBins;
  count_span(a + r * stride_a, na, bins_a, lane);
  count_span(b + r * stride_b, nb, bins_b, lane);
  __syncwarp();
  int inter = 0;
  for (int c = lane; c < kAscii; c += kWideLanes)
    inter += (int)min(bins_a[c * kWideRows], bins_b[c * kWideRows]);
  inter = LaneGroup<kWideLanes>().sum(inter);  // over the row's lanes
  if (live && lane == 0) out[r] = inter;
}

cudaError_t launch_hist(const int8_t* a, const int8_t* b, long long sa, long long sb,
                        const int* la, const int* lb, int* out, int n, int L,
                        cudaStream_t stream) {
  if (L > kNarrowHist) {
    const int rows_per_block = kWarps * kWideRows;
    constexpr int smem = kWarps * 2 * kWideBins * 4;  // under the 48 KB a launch may take
    hist_wide_kernel<<<(n + rows_per_block - 1) / rows_per_block, kThreads, smem, stream>>>(
        a, b, sa, sb, la, lb, out, n, L);
    return cudaGetLastError();
  }
  const int smem = kWarps * narrow_warp_bytes(L);
  const cudaError_t err = cudaFuncSetAttribute(
      hist_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  hist_narrow_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
      a, b, sa, sb, la, lb, out, n, L, packed);
  return cudaGetLastError();
}

}  // namespace
}  // namespace strsim

// Row r of a starts at a + r * stride_a elements (likewise b), so a and b may
// be column slices of one packed [n, 2L] tile. elem_bytes: 1 (int8) or 4
// (int32). Returns the launch's cudaError_t (0 on success).
extern "C" int strsim_multiset_rank(const void* a, const void* b,
                                    long long stride_a, long long stride_b,
                                    const void* len_a, const void* len_b,
                                    void* out, int n, int L, int elem_bytes,
                                    void* stream) {
  if (n <= 0 || L <= 0 || (L + 31) / 32 > strsim::kRankMaxWords)
    return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)strsim::launch_rank<int8_t>(a, b, stride_a, stride_b, la, lb, o, n, L, s);
  if (elem_bytes == 4)
    return (int)strsim::launch_rank<int32_t>(a, b, stride_a, stride_b, la, lb, o, n, L, s);
  return (int)cudaErrorInvalidValue;
}

// 8-bit tiles only (the wrapper checks the dtype).
extern "C" int strsim_multiset_hist(const void* a, const void* b,
                                    long long stride_a, long long stride_b,
                                    const void* len_a, const void* len_b,
                                    void* out, int n, int L, void* stream) {
  if (n <= 0 || L <= 0 || L > strsim::kHistMaxWidth) return (int)cudaErrorInvalidValue;
  return (int)strsim::launch_hist(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b), stride_a, stride_b,
      static_cast<const int*>(len_a), static_cast<const int*>(len_b), static_cast<int*>(out), n, L,
      static_cast<cudaStream_t>(stream));
}
