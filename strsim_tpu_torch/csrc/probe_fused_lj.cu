// An A/B probe of the fused lev + jaro kernel K5 (lev_jaro_fused.cu), K19:
// the jaro scan builds b's equality word for each a-position, a bit
// transpose turns those words into the Myers scan's words, and the Myers
// scan reads them, so that one build of the L x L equality matrix serves
// both. A thread a row; int8 tiles, L <= 31 (one flag word).
//
// Replaces tools/ab_fused_lj.py `_fused_kernel` :86 (launched at :211), with
// its `_transpose_bits` :47. Contract, as
// strsim_tpu_torch/probes/myers.py:fused_lev_jaro_plain: raw (lev, m, t),
// no len-1/len-1 patch;
//   * jaro: bound = max(la, lb) / 2 - 1; a-position i < L is active when
//     i < la and i < lb + bound; its word EqB_i has bit j = (b_j == a_i),
//     j < L; the candidates in [i - bound, min(i + bound, lb - 1)] not yet
//     flagged, the lowest one flagged; the matched chars of each side in
//     rank order a byte a rank, four ranks a word (sign-extended chars ORed
//     in, as the probe's i32 lanes do), t the bytes that differ;
//   * lev: the Myers scan of K1 (pattern a, text b) over Eq_j = the
//     transpose of the EqB words (bit i of Eq_j = bit j of EqB_i), the score
//     from la tracking bit max(la - 1, 0) % 32, steps j < min(lb, L).
//
// What bounds it on this card: the L x L compares of the build (961 at w31,
// each a compare, a shift and an OR), then per step the jaro window and
// greedy pick (about 10 operations) and the Myers step (about 17), and the
// transpose (5 rounds of 16 delta swaps of 6 operations at 32 x 32, 4 of 8
// at 16 x 16). All of it is issue, not memory: a row is at most 62 bytes.
//
// The design. One thread a row keeps the whole row in registers: b's chars
// (NT of them), the NT EqB words, the byte slots of both sides (NT / 4 words
// each) and the Myers state, where NT = 16 for L <= 16 and 32 above, as the
// probe's transpose tile. The delta-swap ladder needs every one of the NT
// words at once, with indices known when the kernel is built, so the kernel
// is a template on NT and every loop over positions is unrolled to NT with
// the positions past L masked off; nothing is indexed at run time, so
// nothing needs local memory (PERF.md records ptxas's registers, stack and
// spills). The alternatives the design left out:
// staging the words in shared memory would add 2 x NT shared-memory
// accesses a row to the ladder's register operations, and a transpose by
// __ballot_sync needs a row's words spread over 32 lanes, which a thread a
// row does not have. The warp's rows are staged in shared memory once with
// coalesced loads (lanes.cuh:stage_rows); each thread then reads its own
// row from there.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxWidth = 31;

// One round of Hacker's Delight's delta-swap transpose (7-3) at distance J
// with mask m, then the rounds below it: afterwards x[i] bit k = the input's
// x[k] bit i, for i, k < N.
template <int N, int J>
__device__ __forceinline__ void delta_swap(uint32_t (&x)[N], uint32_t m) {
#pragma unroll
  for (int k = 0; k < N; k += 2 * J) {
#pragma unroll
    for (int i = k; i < k + J; ++i) {
      const uint32_t t = (x[i] ^ (x[i + J] << J)) & m;
      x[i] ^= t;
      x[i + J] ^= t >> J;
    }
  }
  if constexpr (J > 1) delta_swap<N, J / 2>(x, m ^ (m >> (J / 2)));
}

template <int N>
__device__ __forceinline__ void transpose_bits(uint32_t (&x)[N]) {
  delta_swap<N, N / 2>(x, N == 32 ? 0xFFFF0000u : 0x0000FF00u);  // the high half first
}

// rank `rank`'s char c into byte rank % 4 of slot word rank / 4; every word
// takes a select, so that the words stay in registers
template <int W>
__device__ __forceinline__ void put_rank(uint32_t (&slots)[W], int rank, int c) {
  const uint32_t val = (uint32_t)c << ((rank & 3) << 3);
#pragma unroll
  for (int w = 0; w < W; ++w) slots[w] |= (rank >> 2) == w ? val : 0u;
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
    fused_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, long long stride_a,
                 long long stride_b, const int* __restrict__ len_a, const int* __restrict__ len_b,
                 int* __restrict__ lev_out, int* __restrict__ m_out, int* __restrict__ t_out,
                 int n, int L, bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSlots = NT / 4;
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kWarp;
  if (r0 >= n) return;
  const int rows = (int)min((long long)kWarp, (long long)n - r0);
  const int8_t* staged = stage_rows<int8_t>(smem + (size_t)warp * stage_bytes<int8_t>(kWarp, L), a,
                                            b, stride_a, stride_b, r0, rows, L, packed, wl);
  __syncwarp();
  if (wl >= rows) return;
  const long long r = r0 + wl;
  const int8_t* sa = staged + 2LL * L * wl;
  const int8_t* sb = sa + L;
  const int la = len_a[r], lb = len_b[r];
  const int bound = max(la, lb) / 2 - 1;
  const uint32_t in_tile = low_bits(L);

  int bc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) bc[j] = j < L ? (int)sb[j] : 0;

  // the jaro scan, keeping each a-position's EqB word
  uint32_t eq[NT], seq_a[kSlots] = {}, flag = 0u;
  int m = 0;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    uint32_t w = 0u;
    if (i < L) {
      const int c = sa[i];
#pragma unroll
      for (int j = 0; j < NT; ++j) w |= (uint32_t)(bc[j] == c) << j;
      w &= in_tile;
      const uint32_t win = low_bits(min(i + bound, lb - 1) + 1) & ~low_bits(i - bound);
      const uint32_t cand = (i < la && i < lb + bound) ? w & ~flag & win : 0u;
      if (cand) {
        flag |= cand & (0u - cand);
        put_rank(seq_a, m, c);
        ++m;
      }
    }
    eq[i] = w;
  }

  // b's flagged chars in rank order, then t: the rank bytes that differ
  uint32_t seq_b[kSlots] = {};
  int rank = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if ((flag >> j) & 1u) put_rank(seq_b, rank++, bc[j]);
  int t = 0;
#pragma unroll
  for (int w = 0; w < kSlots; ++w) t += __popc(__vcmpne4(seq_a[w], seq_b[w])) >> 3;

  // Myers over the transposed words: eq[j] bit i = (a_i == b_j)
  transpose_bits(eq);
  const int nb = min(max(lb, 0), L);
  const unsigned hbit = (unsigned)max(la - 1, 0) & 31u;
  uint32_t pv = 0xFFFFFFFFu, mv = 0u;
  int score = la;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nb) {
      const uint32_t e = eq[j];
      const uint32_t xh = (((e & pv) + pv) ^ pv) | e;
      const uint32_t xv = e | mv;
      const uint32_t ph = mv | ~(xh | pv);
      const uint32_t mh = pv & xh;
      score += (int)((ph >> hbit) & 1u) - (int)((mh >> hbit) & 1u);
      const uint32_t ph_s = (ph << 1) | 1u;
      pv = (mh << 1) | ~(xv | ph_s);
      mv = ph_s & xv;
    }
  }
  lev_out[r] = score;
  m_out[r] = m;
  t_out[r] = t;
}

template <int NT>
cudaError_t launch_fused(const int8_t* a, const int8_t* b, long long sa, long long sb,
                         const int* la, const int* lb, int* lev, int* m, int* t, int n, int L,
                         cudaStream_t stream) {
  const int smem = kWarps * stage_bytes<int8_t>(kWarp, L);
  const auto kernel = fused_kernel<NT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(a, b, sa, sb, la, lb, lev, m, t,
                                                                    n, L, packed);
  return cudaGetLastError();
}

}  // namespace
}  // namespace strsim

// K19. Row r of a starts at a + r * stride_a int8 chars (likewise b), so a
// and b may be column slices of one packed [n, 2L] tile; L <= 31. Writes the
// raw lev, m and t of each row. Returns the launch's cudaError_t (0 on
// success).
extern "C" int strsim_probe_fused_lev_jaro(const void* a, const void* b, long long stride_a,
                                           long long stride_b, const void* len_a,
                                           const void* len_b, void* lev_out, void* m_out,
                                           void* t_out, int n, int L, void* stream) {
  using namespace strsim;
  if (n <= 0 || L <= 0 || L > kMaxWidth) return (int)cudaErrorInvalidValue;
  const int8_t* ta = static_cast<const int8_t*>(a);
  const int8_t* tb = static_cast<const int8_t*>(b);
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* lev = static_cast<int*>(lev_out);
  int* m = static_cast<int*>(m_out);
  int* t = static_cast<int*>(t_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 16) return (int)launch_fused<16>(ta, tb, stride_a, stride_b, la, lb, lev, m, t, n, L, s);
  return (int)launch_fused<32>(ta, tb, stride_a, stride_b, la, lb, lev, m, t, n, L, s);
}
