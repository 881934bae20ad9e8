// Four A/B probes of the jaro scan K2 (jaro_scan.cu), K12-K15: K12-K14 one
// kernel template on K2's lane groups (lanes.cuh), cut or changed by `P`;
// K15 K2's own kernel (jaro_body.cuh) cut by its mode.
//
// Replaces the TPU probes of tools/ (each file's kernel and wrapper):
//   K12 ab_jaro_pallas.py  _scan_kernel :59          P = kFlags
//   K13 ab_jaro_wide.py    _kernel_wide :38          P = kPackedT
//   K14 ab_jaro_wide2.py   _kernel_wide_clipped :56  P = kClipWarp, kClipRow
//   K15 ab_jaro_sol_probe.py _ablated_kernel :62     jaro_body.cuh, kJaroFull .. kJaroEqbOnly
// Contract of the scan as in jaro_scan.cu and ops/jaro_cuda.py; every probe
// writes raw stats (no len-1/len-1 patch: those rows have an empty window,
// m = t = 0), the wrappers in probes/jaro.py patch K12's and K13's, as the
// TPU wrappers do.
//
// What bounds them on this card is K2's: the instructions and latency of a
// step a char, not memory (at most 2 x 511 chars a row). K12-K14 keep the
// design K2 had before it moved to jaro_body.cuh: G lanes a row pair, G the
// word count rounded up to a power of two; rows staged once a warp; b's
// equality word for a_i from the per-row int8 table or, on int32 tiles, by
// 32 register compares; `take_first` flags the group's first candidate.
// What each probe changes:
//   * K12 (G = 1, L <= 32): stops after the scan and stores m and the
//     group's flag words, b's `flag` and a's `mat`, a word a lane at
//     [row * G + lane] (coalesced: a warp's rows are neighbours); t is
//     counted outside (probes/jaro.py:transpositions_from_words). Written
//     for any G, so that K9's redesign can take it; only G = 1 is built.
//   * K13 (int8, G = 4..16): t from rank slots of one byte a rank, four
//     ranks a 32-bit word, compared four ranks an operation (`__vcmpne4`),
//     where K2 writes a 32-bit slot a rank and compares one.
//   * K14 (G = 4..16): at each a-position a lane whose word lies wholly
//     outside [i - bound_max, min(i + bound_max, nb_max - 1)], the union of
//     its warp's windows (the maxima reduced once over the warp, as the TPU
//     probe reduces them over its block), or with kClipRow outside its own
//     row's window, skips its equality read and its candidate step (cand =
//     0); `take_first` still runs on every lane.
//   * K15: K2's kernel as jaro_scan.cu builds it, with its raw m: mode
//     full the whole body; no_tcount leaves out the transposition count (t
//     = m); scan_only also a's matched bits (t = m); eqb_only only reads the
//     equality words: m = t = the XOR of b's word for every a-position i <
//     L, over the group.
#include <cuda_runtime.h>
#include <stdint.h>

#include "jaro_body.cuh"

namespace strsim {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxWords = 16;

enum Probe : int { kFlags, kPackedT, kClipWarp, kClipRow };  // K12, K13, K14 (two clips)

// the group sizes each probe is built for
constexpr bool builds(int P, int G) { return P == kFlags ? G == 1 : G >= 4; }

// shared memory of one warp: the int8 equality table
// (reused for the rank slots once the scan is done) or the int32 rank slots
// (none at G <= 2), then its staged rows
template <typename T, int G>
__host__ __device__ constexpr int warp_bytes(int L) {
  return (lane_table<T> ? kTableBytes : kRankSlotBytes<G>) + stage_bytes<T>(kWarp / G, L);
}

// K13's t: the lanes write their matched a chars and flagged b chars in rank
// order, a byte a rank, into `scratch` (2 KB a warp, over the table): word q
// of the group's a ranks (ranks 4q .. 4q + 3) is scratch word
// ((q / G) << 5) + base + q % G, b's are 8 rows of 32 words further on, so
// that lane k reads its own column. Then each lane compares its words four
// ranks at a time; the bytes past m in the last word are masked off.
template <typename T, int G>
__device__ __forceinline__ int packed_transpositions(const LaneGroup<G>& g, uint32_t* scratch,
                                                     const T* sa, const T* sb, uint32_t mat,
                                                     uint32_t flag, int m) {
  unsigned char* slot = reinterpret_cast<unsigned char*>(scratch);
  const auto word = [&](int q) { return ((q / G) << 5) + g.base + (q & (G - 1)); };
  const int base = 32 * g.lane;
  int s = g.exclusive_sum(__popc(mat));
  for (uint32_t x = mat; x; x &= x - 1u, ++s)
    slot[4 * word(s >> 2) + (s & 3)] = (unsigned char)sa[base + __ffs(x) - 1];
  s = g.exclusive_sum(__popc(flag));
  for (uint32_t x = flag; x; x &= x - 1u, ++s)
    slot[4 * word(8 * G + (s >> 2)) + (s & 3)] = (unsigned char)sb[base + __ffs(x) - 1];
  g.sync();
  int t = 0;
  for (int q = g.lane; 4 * q < m; q += G) {
    const uint32_t keep = 4 * q + 4 <= m ? 0xFFFFFFFFu : low_bits(8 * (m - 4 * q));
    t += __popc(__vcmpne4(scratch[word(q)], scratch[word(8 * G + q)]) & keep) >> 3;
  }
  return g.sum(t);
}

// out0: m; out1: t (K12: the flag words of b); out2: K12's matched words of a
template <typename T, int G, int P>
__global__ void __launch_bounds__(kThreads)
    probe_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                 long long stride_b, const int* __restrict__ len_a,
                 const int* __restrict__ len_b, int* __restrict__ out0,
                 int* __restrict__ out1, int* __restrict__ out2, int n, int L, bool packed) {
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
  const int bound = max(la, lb) / 2 - 1;
  const int i_end = max(min(min(la, lb + bound), L), 0);
  const int nb = min(max(lb, 0), L);
  const int base = 32 * g.lane;  // b- and a-positions of this lane's word
  const int own = min(max(nb - base, 0), 32);
  const LaneEq<T> eq(table_words, wl, sb + base, own);
  const int steps = g.warp_max(i_end);
  int bound_max = 0, nb_max = 0;  // K14: the warp's window union
  if constexpr (P == kClipWarp) {
    bound_max = (int)__reduce_max_sync(kFull, (unsigned)max(bound, 0));
    nb_max = (int)__reduce_max_sync(kFull, (unsigned)nb);
  }
  // does this lane's word meet the window at a-position i?
  const auto meets = [&](int i) {
    if constexpr (P == kClipWarp)
      return base <= min(i + bound_max, nb_max - 1) && base + 32 > i - bound_max;
    else if constexpr (P == kClipRow)
      return i < i_end && base <= min(i + bound, nb - 1) && base + 32 > i - bound;
    else
      return true;
  };

  uint32_t flag = 0u, mat = 0u;
  int m = 0;
  uint32_t e_next = meets(0) ? eq(sa[0]) : 0u;
  for (int i = 0; i < steps; ++i) {
    const uint32_t e = e_next;
    const bool on = meets(i) && (G == 1 || i < i_end);
    // the next step's word, read ahead
    e_next = meets(i + 1) ? eq(sa[max(min(i + 1, i_end - 1), 0)]) : 0u;
    uint32_t cand = 0u;
    if (on) {
      const int lo = max(i - bound, 0) - base;
      const int hi = min(i + bound, nb - 1) - base;
      cand = e & ones_from(lo) & ~ones_from(hi + 1) & ~flag;
    }
    if (take_first(g, cand, flag)) {  // the first match
      if (g.lane == (i >> 5)) mat |= 1u << (i & 31);
      ++m;
    }
  }

  if constexpr (P == kFlags) {
    if (live) {
      out1[r * G + g.lane] = (int)flag;
      out2[r * G + g.lane] = (int)mat;
      if (g.lane == 0) out0[r] = m;
    }
  } else {
    g.sync();  // the table's last reads are done: the rank slots overlay it
    int t;
    if constexpr (P == kPackedT)
      t = packed_transpositions(g, table_words, sa, sb, mat, flag, m);
    else
      t = jaro_transpositions(g, table_words, sa, sb, mat, flag, m);
    if (live && g.lane == 0) {
      out0[r] = m;
      out1[r] = t;
    }
  }
}

template <typename T, int P, int G>
cudaError_t launch_g(const void* va, const void* vb, long long sa, long long sb, const int* la,
                     const int* lb, int* o0, int* o1, int* o2, int n, int L,
                     cudaStream_t stream) {
  if constexpr (!builds(P, G)) {
    return cudaErrorInvalidValue;
  } else {
    const T* a = static_cast<const T*>(va);
    const T* b = static_cast<const T*>(vb);
    const int rows_per_block = kWarps * (kWarp / G);
    const int smem = kWarps * warp_bytes<T, G>(L);
    const auto kernel = probe_kernel<T, G, P>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
    kernel<<<(n + rows_per_block - 1) / rows_per_block, kThreads, smem, stream>>>(
        a, b, sa, sb, la, lb, o0, o1, o2, n, L, packed);
    return cudaGetLastError();
  }
}

template <typename T, int P>
cudaError_t launch_t(const void* a, const void* b, long long sa, long long sb, const int* la,
                     const int* lb, int* o0, int* o1, int* o2, int n, int L,
                     cudaStream_t stream) {
  switch (group_lanes((L + 31) / 32)) {
    case 1: return launch_g<T, P, 1>(a, b, sa, sb, la, lb, o0, o1, o2, n, L, stream);
    case 2: return launch_g<T, P, 2>(a, b, sa, sb, la, lb, o0, o1, o2, n, L, stream);
    case 4: return launch_g<T, P, 4>(a, b, sa, sb, la, lb, o0, o1, o2, n, L, stream);
    case 8: return launch_g<T, P, 8>(a, b, sa, sb, la, lb, o0, o1, o2, n, L, stream);
    default: return launch_g<T, P, 16>(a, b, sa, sb, la, lb, o0, o1, o2, n, L, stream);
  }
}

// Row r of a starts at a + r * stride_a elements (likewise b); elem_bytes 1
// (int8) or 4 (int32; not K13). Returns the launch's cudaError_t.
template <int P>
int launch(const void* a, const void* b, long long sa, long long sb, const void* len_a,
           const void* len_b, void* o0, void* o1, void* o2, int n, int L, int elem_bytes,
           void* stream) {
  if (n <= 0 || L <= 0 || (L + 31) / 32 > kMaxWords) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* p0 = static_cast<int*>(o0);
  int* p1 = static_cast<int*>(o1);
  int* p2 = static_cast<int*>(o2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1) return (int)launch_t<int8_t, P>(a, b, sa, sb, la, lb, p0, p1, p2, n, L, s);
  if constexpr (P != kPackedT) {
    if (elem_bytes == 4) return (int)launch_t<int32_t, P>(a, b, sa, sb, la, lb, p0, p1, p2, n, L, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace strsim

// K12: m, b's flag word and a's matched word of each row, L <= 32.
extern "C" int strsim_probe_jaro_flags(const void* a, const void* b, long long stride_a,
                                       long long stride_b, const void* len_a, const void* len_b,
                                       void* m_out, void* flagged_out, void* matched_out, int n,
                                       int L, int elem_bytes, void* stream) {
  return strsim::launch<strsim::kFlags>(a, b, stride_a, stride_b, len_a, len_b, m_out,
                                        flagged_out, matched_out, n, L, elem_bytes, stream);
}

// K13: raw m, t with t on byte slots; int8 tiles, 65 <= L <= 512.
extern "C" int strsim_probe_jaro_packed_t(const void* a, const void* b, long long stride_a,
                                          long long stride_b, const void* len_a,
                                          const void* len_b, void* m_out, void* t_out, int n,
                                          int L, int elem_bytes, void* stream) {
  return strsim::launch<strsim::kPackedT>(a, b, stride_a, stride_b, len_a, len_b, m_out, t_out,
                                          nullptr, n, L, elem_bytes, stream);
}

// K14: raw m, t; clip 0 the warp's window union, 1 the row's window; 65 <= L <= 512.
extern "C" int strsim_probe_jaro_clipped(const void* a, const void* b, long long stride_a,
                                         long long stride_b, const void* len_a, const void* len_b,
                                         void* m_out, void* t_out, int n, int L, int elem_bytes,
                                         int clip, void* stream) {
  if (clip == 0)
    return strsim::launch<strsim::kClipWarp>(a, b, stride_a, stride_b, len_a, len_b, m_out,
                                             t_out, nullptr, n, L, elem_bytes, stream);
  if (clip == 1)
    return strsim::launch<strsim::kClipRow>(a, b, stride_a, stride_b, len_a, len_b, m_out,
                                            t_out, nullptr, n, L, elem_bytes, stream);
  return (int)cudaErrorInvalidValue;
}

// K15: raw m, t of K2's kernel (jaro_body.cuh) cut by mode 0 full, 1
// no_tcount, 2 scan_only, 3 eqb_only; elem_bytes 1 (int8) or 4 (int32).
extern "C" int strsim_probe_jaro_ablated(const void* a, const void* b, long long stride_a,
                                         long long stride_b, const void* len_a, const void* len_b,
                                         void* m_out, void* t_out, int n, int L, int elem_bytes,
                                         int mode, void* stream) {
  using namespace strsim;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const JaroLaunch f{a, b, stride_a, stride_b, static_cast<const int*>(len_a),
                     static_cast<const int*>(len_b), static_cast<int*>(m_out),
                     static_cast<int*>(t_out), nullptr, n, L, static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case 0: return (int)jaro_select_elem<kJaroFull, false>(elem_bytes, L, f);
    case 1: return (int)jaro_select_elem<kJaroNoTcount, false>(elem_bytes, L, f);
    case 2: return (int)jaro_select_elem<kJaroScanOnly, false>(elem_bytes, L, f);
    case 3: return (int)jaro_select_elem<kJaroEqbOnly, false>(elem_bytes, L, f);
    default: return (int)cudaErrorInvalidValue;
  }
}
