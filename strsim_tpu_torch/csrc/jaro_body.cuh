// The jaro scan's kernel, a group of lanes per row pair: K2's whole body
// (jaro_scan.cu), the cuts of it that the probe K15 times (probe_jaro.cu),
// so that K15 attributes K2's own time, and K9's scan with its flags
// (jaro_flags.cu).
//
// Contract of the scan (jaro_scan.cu, ops/jaro_cuda.py): bound = max(la,
// lb) / 2 - 1; a-positions i < min(la, lb + bound) each flag the first
// unflagged b-position j with b_j == a_i in [max(i - bound, 0), min(i +
// bound, lb - 1)]; m counts them; t counts the ranks r where the r-th
// matched a char differs from the r-th flagged b char.
//
// What bounds it on this card: the greedy chain, one dependent step per
// a-position (rows of up to 511 chars), and, on int8 rows, the 16 KB
// equality table a warp that caps an SM at 3 blocks (12 warps); not memory.
// The design, against that:
//   * G lanes a row pair, G the word count rounded up to a power of two;
//     lane w holds word w of b's flag vector and of a's matched vector; the
//     warp stages its rows once (lanes.cuh).
//   * b's equality word for a_i: on int8 rows of at most 16 chars, 8 or 16
//     register compares, so that those warps need no table (a few KB a
//     block); on wider int8 rows one read of the per-row table; on int32
//     rows 8, 16 or 32 register compares, as many as the width gives a lane.
//   * Only `flag` carries from step to step. The equality word of each
//     a-position and its window mask are computed ahead (kAhead positions
//     at G >= 4, one below), in registers and without a branch, so that
//     their shared-memory reads overlap the steps before and a step waits
//     only on its own chain: clear the flagged bits, one warp ballot, a
//     test of the group's lanes below this one in that ballot, and the
//     lowest candidate bit set in `flag`. No branch in the step either: the
//     groups of a warp decide apart.
//   * The steps run a's words in turn, each setting one bit of a register
//     that the word's lane keeps as its matched word; m is the group's
//     popcount of those after the scan; t comes from the matched and
//     flagged bits (lanes.cuh: jaro_transpositions).
//   * Each instantiation sets its dynamic shared memory and the carveout
//     (all shared) once a device, and names in __launch_bounds__ the blocks
//     an SM can hold by shared memory (at most 8), so that ptxas keeps the
//     registers that residency leaves it.
// Each choice (two a-positions ahead at G >= 4, the table at int8 w17..w32,
// those launch bounds, the carveout, the steps unrolled 4 times) won its
// A/B on an H100 (PERF.md section 6, PR 12).
// Chars are compared as they are, exact for every codepoint, astral ones
// included, on int8 and int32 tiles alike.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kJaroThreads = 128;
constexpr int kJaroWarps = kJaroThreads / kWarp;
constexpr int kJaroMaxWords = 16;
constexpr int kAhead = 2;  // a-positions computed ahead of the step at G >= 4 (1 below)
constexpr int kJaroMaxDevices = 64;  // devices whose configuration is kept (others set it a launch)
constexpr int kSmBytes = 233472;     // an SM's shared memory at the largest carveout
constexpr int kBlockReserved = 1024;  // the system's share of each resident block

// What a build computes: K2 (m patched for len-1/len-1 rows, the prefix
// when asked), then K15's cuts, raw: the full body; without the
// transposition count (t = m); without a's matched bits either (t = m);
// only the equality reads (m = t = the XOR of b's word for every
// a-position i < L, over the group); then K9's: the scan raw (m, no t) and
// both flag sets as [n, L] bytes (`jaro_store_flags`).
enum JaroCut : int { kJaroK2, kJaroFull, kJaroNoTcount, kJaroScanOnly, kJaroEqbOnly, kJaroFlags };

// A warp's shared memory: the int8 equality table, which the rank slots
// overlay once the scan is done, or the rank slots alone (none at G <= 2),
// then its staged rows.
template <typename T, int G, bool kTable>
__host__ __device__ constexpr int jaro_warp_bytes(int L) {
  return (kTable ? kTableBytes : kRankSlotBytes<G>) + stage_bytes<T>(kWarp / G, L);
}

// The widest row an instantiation takes: N chars at G = 1, else 32G.
template <int G, int N>
constexpr int jaro_max_width = G == 1 ? N : 32 * G;

// Blocks an SM holds by shared memory at the instantiation's widest row, at
// most 8 (which leaves ptxas 64 registers a thread).
template <typename T, int G, int N, bool kTable>
constexpr int kJaroBlocksBySmem =
    kSmBytes / (kJaroWarps * jaro_warp_bytes<T, G, kTable>(jaro_max_width<G, N>) + kBlockReserved);
template <typename T, int G, int N, bool kTable>
constexpr int kJaroBlocksPerSm =
    kJaroBlocksBySmem<T, G, N, kTable> < 8 ? kJaroBlocksBySmem<T, G, N, kTable> : 8;

// TableEq (lanes.cuh) with its sign mask taken by an arithmetic shift: two
// operations a read, where the compare and select of TableEq compile to six
struct JaroTableEq : TableEq {
  using TableEq::TableEq;
  __device__ __forceinline__ uint32_t operator()(int8_t ch) const {
    const int c = ch;
    return col[(c & (kAscii - 1)) * kWarp] & (below ^ ~(uint32_t)(c >> 31));
  }
};

// K9's epilogue, once the scan is done: one [n, L] byte tensor's span of the
// warp's rows (rows r0 .. r0 + rows - 1, contiguous in `out`) from each
// lane's word of it (`bits`, positions 32 * lane ..; zero past the lengths),
// group k of the warp holding row r0 + k. The lanes expand their words into
// `buf` (rows * L + 15 bytes of the warp's shared memory, 16-byte aligned),
// shifted as the span is from a 16-byte boundary, then the warp stores the
// span with 16-byte stores from its aligned interior and byte stores at its
// two ends (rows of odd width start anywhere).
template <int G>
__device__ __forceinline__ void jaro_store_flags(const LaneGroup<G>& g, unsigned char* buf,
                                                 uint8_t* out, long long r0, int rows, int L,
                                                 int k, uint32_t bits, int wl) {
  unsigned char* dst = out + r0 * L;
  const int bytes = rows * L;
  const int mis = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  unsigned char* src = buf + mis;
  if (k < rows) {
    unsigned char* row = src + k * L + 32 * g.lane;
    const int count = L - 32 * g.lane;  // this lane's positions in the row
#pragma unroll
    for (int q = 0; q < 32; ++q)
      if (q < count) row[q] = (unsigned char)((bits >> q) & 1u);
  }
  __syncwarp();
  const int head = min((16 - mis) & 15, bytes);
  const int body = (bytes - head) >> 4;
  for (int q = wl; q < head; q += kWarp) dst[q] = src[q];
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int q = wl; q < body; q += kWarp) d4[q] = s4[q];
  for (int q = head + (body << 4) + wl; q < bytes; q += kWarp) dst[q] = src[q];
  __syncwarp();  // the buffer is free again
}

template <int G>
__device__ __forceinline__ uint32_t jaro_group_xor(uint32_t v) {
#pragma unroll
  for (int d = 1; d < G; d <<= 1) v ^= __shfl_xor_sync(kFull, v, d, G);
  return v;
}

// T: tile chars; G: lanes a row; N: chars of a lane's word compared in
// registers, or (kTable) read from the int8 table; kPrefix: K2 writes the
// common prefix, capped at min(L, 4), to prefix_out. matched_out and
// flagged_out: K9's [n, L] byte tensors (kJaroFlags, which writes no t).
template <typename T, int G, int N, bool kTable, int Cut, bool kPrefix>
__global__ void __launch_bounds__(kJaroThreads, (kJaroBlocksPerSm<T, G, N, kTable>))
    jaro_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                long long stride_b, const int* __restrict__ len_a,
                const int* __restrict__ len_b, int* __restrict__ m_out,
                int* __restrict__ t_out, int* __restrict__ prefix_out, int n, int L,
                bool packed, uint8_t* __restrict__ matched_out,
                uint8_t* __restrict__ flagged_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Eq = std::conditional_t<kTable, JaroTableEq, RegisterEq<T, N>>;
  constexpr int kAheadG = G >= 4 ? kAhead : 1;  // a-positions computed ahead
  constexpr int kRows = kWarp / G;
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kJaroWarps + warp) * kRows;
  if (r0 >= n) return;
  const int rows = (int)min((long long)kRows, (long long)n - r0);
  unsigned char* wsm = smem + (size_t)warp * jaro_warp_bytes<T, G, kTable>(L);
  uint32_t* scratch = reinterpret_cast<uint32_t*>(wsm);  // the table, then the rank slots
  if constexpr (kTable) clear_table(scratch, wl);
  unsigned char* stage = wsm + (kTable ? kTableBytes : kRankSlotBytes<G>);
  const T* staged = stage_rows<T>(stage, a, b, stride_a, stride_b, r0, rows, L, packed, wl);
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
  const int bound = max(la, lb) / 2 - 1;
  const int i_end = max(min(min(la, lb + bound), L), 0);  // la == lb == 1 gives 0
  const int nb = min(max(lb, 0), L);
  const int base = 32 * g.lane;  // b- and a-positions of this lane's word
  const Eq eq(scratch, wl, sb + base, min(max(nb - base, 0), 32));

  int m, t;
  if constexpr (Cut == kJaroEqbOnly) {
    uint32_t acc = 0u;
    for (int i = 0; i < L; ++i) acc ^= eq(sa[i]);
    m = t = (int)jaro_group_xor<G>(acc);
  } else {
    // this lane's window bits for a_i: [i - bound, min(i + bound, nb - 1)]
    // less `base`, as shifts of all ones (ones_from clamps them to 0..32)
    const int c_lo = bound + base, c_hi = bound + 1 - base, c_nb = nb - base;
    // a_i's candidates here, flags aside: no branch, so that the reads of a
    // step ahead overlap the steps before it (past a's chars the read lands
    // in b's staged row and i_end masks it off)
    const auto word = [&](int i) -> uint32_t {
      const uint32_t e = eq(sa[min(i, L)]);
      return e & ones_from(i - c_lo) & ~ones_from(min(i + c_hi, c_nb)) & (0u - (i < i_end));
    };
    // in a warp ballot: the group's lanes below this one, and the group
    const unsigned below = ((1u << wl) - 1u) & ~((1u << g.base) - 1u);
    const unsigned group = ((1u << G) - 1u) << g.base;
    const int steps = g.warp_max(i_end);

    uint32_t flag = 0u, mat = 0u, ahead[kAheadG];
    int found_count = 0;
#pragma unroll
    for (int d = 0; d < kAheadG; ++d) ahead[d] = word(d);
    // a's words in turn: the steps of word w set the bits of `hits`, which
    // the lane that owns word w keeps as its `mat`
    for (int w0 = 0; w0 < steps; w0 += 32) {
      const int k_end = min(32, steps - w0);
      uint32_t hits = 0u;
#pragma unroll 4
      // whole groups of kAheadG steps: a step past i_end finds nothing
      for (int k0 = 0; k0 < k_end; k0 += kAheadG) {
#pragma unroll
        for (int d = 0; d < kAheadG; ++d) {
          const int k = k0 + d;
          const uint32_t cand = ahead[d] & ~flag;
          ahead[d] = word(w0 + k + kAheadG);
          // selects, not branches: the groups of a warp decide apart
          bool found;
          if constexpr (G == 1) {
            found = cand != 0u;
            flag |= cand & (0u - cand);
          } else {
            const unsigned vote = __ballot_sync(kFull, cand != 0u);
            flag |= (vote & below) == 0u ? cand & (0u - cand) : 0u;  // the group's first
            found = (vote & group) != 0u;
          }
          if constexpr (Cut == kJaroScanOnly)
            found_count += found;
          else
            hits |= found ? 1u << k : 0u;
        }
      }
      if (g.lane == (w0 >> 5)) mat = hits;
    }
    if constexpr (Cut == kJaroScanOnly) {
      m = t = found_count;
    } else {
      m = g.sum(__popc(mat));
      if constexpr (Cut == kJaroFlags) {
        // the staged rows' last reads are done: the flags go out through them
        t = m;
        __syncwarp();
        jaro_store_flags(g, stage, matched_out, r0, rows, L, k, mat, wl);
        jaro_store_flags(g, stage, flagged_out, r0, rows, L, k, flag, wl);
      } else if constexpr (Cut == kJaroNoTcount) {
        t = m;
      } else {
        g.sync();  // the table's last reads are done: the rank slots overlay it
        t = jaro_transpositions(g, scratch, sa, sb, mat, flag, m);
      }
    }
  }

  if (live && g.lane == 0) {
    if constexpr (Cut == kJaroK2) {
      m_out[r] = la == 1 && lb == 1 ? (sa[0] == sb[0] ? 1 : 0) : m;  // strsim.rs:197-199
      if constexpr (kPrefix) {
        int prefix = 0;  // pads differ per side, so no length mask is needed
        const int k_max = min(L, 4);
        while (prefix < k_max && sa[prefix] == sb[prefix]) ++prefix;
        prefix_out[r] = prefix;
      }
    } else {
      m_out[r] = m;
    }
    if constexpr (Cut != kJaroFlags) t_out[r] = t;
  }
}

// Dynamic shared memory up to the instantiation's widest row, and the
// carveout at all shared, on the current device.
template <typename K>
cudaError_t jaro_configure(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// One launch of the instantiation `run` names, on rows r of a at a + r *
// stride_a elements (likewise b); prefix may be null unless kPrefix, t and
// the flags are null but for the cuts that write them.
struct JaroLaunch {
  const void* a;
  const void* b;
  long long stride_a, stride_b;
  const int *len_a, *len_b;
  int *m, *t, *prefix;
  int n, L;
  cudaStream_t stream;
  uint8_t* matched = nullptr;
  uint8_t* flagged = nullptr;

  template <typename T, int G, int N, bool kTable, int Cut, bool kPrefix>
  cudaError_t run() const {
    const auto kernel = jaro_kernel<T, G, N, kTable, Cut, kPrefix>;
    // the attributes belong to a device's context: set once a device, and
    // again on the next launch if setting them failed
    static std::atomic<bool> configured[kJaroMaxDevices];
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= kJaroMaxDevices || !configured[device].load(std::memory_order_acquire)) {
      err = jaro_configure(kernel, kJaroWarps * jaro_warp_bytes<T, G, kTable>(jaro_max_width<G, N>));
      if (err != cudaSuccess) return err;
      if (device < kJaroMaxDevices) configured[device].store(true, std::memory_order_release);
    }
    const T* ta = static_cast<const T*>(a);
    const T* tb = static_cast<const T*>(b);
    const bool packed = tb == ta + L && stride_a == 2LL * L && stride_b == 2LL * L;
    const int rows_per_block = kJaroWarps * (kWarp / G);
    const int smem = kJaroWarps * jaro_warp_bytes<T, G, kTable>(L);
    kernel<<<(n + rows_per_block - 1) / rows_per_block, kJaroThreads, smem, stream>>>(
        ta, tb, stride_a, stride_b, len_a, len_b, m, t, prefix, n, L, packed, matched, flagged);
    return cudaGetLastError();
  }
};

// Calls f.run<T, G, N, kTable, Cut, kPrefix>() for the instantiation that
// serves width L (1..512): G = 1 up to 32 chars (N = 8, 16, 32; the int8
// table from 17 chars), else the table on int8.
template <typename T, int Cut, bool kPrefix, typename F>
cudaError_t jaro_select(int L, const F& f) {
  constexpr bool kInt8 = sizeof(T) == 1;
  switch (group_lanes((L + 31) / 32)) {
    case 1:
      if (L <= 8) return f.template run<T, 1, 8, false, Cut, kPrefix>();
      if (L <= 16) return f.template run<T, 1, 16, false, Cut, kPrefix>();
      return f.template run<T, 1, 32, kInt8, Cut, kPrefix>();
    case 2: return f.template run<T, 2, 32, kInt8, Cut, kPrefix>();
    case 4: return f.template run<T, 4, 32, kInt8, Cut, kPrefix>();
    case 8: return f.template run<T, 8, 32, kInt8, Cut, kPrefix>();
    default: return f.template run<T, 16, 32, kInt8, Cut, kPrefix>();
  }
}

// jaro_select on the tile's element size (1: int8, 4: int32), for L in
// 1..512 and n > 0.
template <int Cut, bool kPrefix, typename F>
cudaError_t jaro_select_elem(int elem_bytes, int L, const F& f) {
  if (L <= 0 || (L + 31) / 32 > kJaroMaxWords) return cudaErrorInvalidValue;
  if (elem_bytes == 1) return jaro_select<int8_t, Cut, kPrefix>(L, f);
  if (elem_bytes == 4) return jaro_select<int32_t, Cut, kPrefix>(L, f);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace strsim
