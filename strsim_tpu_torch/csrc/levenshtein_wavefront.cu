// K10: Levenshtein distance by the full dynamic program, a group of lanes per
// row pair, the DP state in registers.
//
// Replaces strsim_tpu/ops/levenshtein_pallas.py: _kernel, behind
// levenshtein_distance_pallas (only a forced levenshtein_impl="pallas"
// reaches it). Same integer contract as the plain torch version in
// strsim_tpu_torch/ops/levenshtein_wavefront_cuda.py:
//   with D[i][j] the edit distance of a[:i] and b[:j], out = D[la][lb] where
//   la + lb >= 2 and 0 where la + lb <= 1 (the TPU wavefront's first
//   capturing diagonal is d = 2); 0 where a length is outside 0..L.
//
// What bounds it on this card: la * lb cells a row, each a three-way min with
// a char compare. The least work for the function is K1's bit-parallel scan
// (la * lb / 32 word steps), so K1's bound stays this kernel's; the full DP's
// own floor is its cells at a few integer operations each.
//
// The design, against that:
//   * G lanes a row pair (1 up to 32, from the width); lane l owns the strip
//     of K consecutive DP rows l*K + 1 .. l*K + K (K = 8, 12 or 16, G*K >=
//     L) and keeps the strip's current column and its K chars of a in
//     registers, every loop over the strip unrolled: no local memory.
//   * Lanes run along the anti-diagonal: lane l takes column j at step
//     j + l - 1. The row above its strip comes from lane l - 1 by one
//     __shfl_up_sync a step (lane 0 has row 0, D[0][j] = j). b is staged
//     once a warp in shared memory (lanes.cuh: stage_rows), and each lane
//     reads its column's char there.
//   * The cell with Hopper's DPX instructions: t_i = min(old_i + 1, old_{i-1}
//     + cost_i) needs nothing from the same column, so all K issue together;
//     the only chain down the strip is v_i = __viaddmin_s32(v_{i-1}, 1, t_i),
//     one instruction a cell.
//   * A warp runs to its rows' last needed step, lb + (la - 1) / K; the lane
//     that holds D[la][*] keeps D[la][lb] when it reaches column lb, so
//     nothing is frozen past a row's end.
//   * On int8 rows wider than 16 chars two row pairs share each 32-bit
//     register in its 16-bit halves (the _s16x2 DPX forms; distances stay
//     below 2^15), the cost of both by one XOR and one DPX min: fewer
//     instructions a cell. Rows come sorted by length, so a warp's
//     neighbouring rows match in length. It won its A/B on an H100 there
//     (1.03..1.40x from w23 up); at G = 1 and on int32 rows, whose chars need
//     two compares, one row pair a lane won (PERF.md section 6).
// Chars are compared as they are on int8 and int32 tiles; chars past a
// length (PAD_A, PAD_B) only reach DP rows past la or columns past lb.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kWfThreads = 128;
constexpr int kWfWarps = kWfThreads / kWarp;
constexpr int kWfMaxWidth = 512;

// The cells of P row pairs a lane: P = 1, 32-bit cells; P = 2 (int8), 16-bit
// halves, half h the lane's h-th row pair.
template <typename T, int P>
struct WfCells;

template <typename T>
struct WfCells<T, 1> {
  using V = int;  // a cell
  using C = int;  // a char
  static __device__ __forceinline__ V splat(int x) { return x; }
  static __device__ __forceinline__ C chars(const T* s0, const T*, int p) { return s0[p]; }
  // old + cost of the chars a and c
  static __device__ __forceinline__ V diag(V old, C a, C c) { return old + (a != c ? 1 : 0); }
  // min(x + 1, y)
  static __device__ __forceinline__ V addmin(V x, V y) { return __viaddmin_s32(x, 1, y); }
  static __device__ __forceinline__ int half(V v, int) { return v; }
};

// both rows' chars in one register, one byte a half
template <>
struct WfCells<int8_t, 2> {
  using V = uint32_t;
  using C = uint32_t;
  static __device__ __forceinline__ V splat(int x) { return (uint32_t)x * 0x00010001u; }
  static __device__ __forceinline__ C chars(const int8_t* s0, const int8_t* s1, int p) {
    return (uint32_t)(uint8_t)s0[p] | (uint32_t)(uint8_t)s1[p] << 16;
  }
  // cost min(a ^ c, 1) a half, by one DPX min; the halves hold small
  // non-negative values, so a 32-bit add carries nothing across
  static __device__ __forceinline__ V diag(V old, C a, C c) {
    return old + __vimin3_u16x2(a ^ c, 0x00010001u, 0x00010001u);
  }
  static __device__ __forceinline__ V addmin(V x, V y) { return __viaddmin_s16x2(x, 0x00010001u, y); }
  static __device__ __forceinline__ int half(V v, int h) { return (int)((h ? v >> 16 : v) & 0xFFFFu); }
};

// res = half h of col[i], when column j is the kept one (j == keep_j): a
// select over the strip, so that col stays in registers. Called with a
// literal h, so that the caller's per-row arrays keep constant indices.
template <typename Cells, int K>
__device__ __forceinline__ void wf_keep(const typename Cells::V (&col)[K], int j, int keep_j,
                                        int i, int h, int& res) {
  if (j == keep_j) {
#pragma unroll
    for (int x = 0; x < K; ++x)
      if (x == i) res = Cells::half(col[x], h);
  }
}

// T: tile chars; G: lanes a row pair; K: DP rows a lane; P: row pairs a lane.
template <typename T, int G, int K, int P>
__global__ void __launch_bounds__(kWfThreads)
    wavefront_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                     long long stride_b, const int* __restrict__ len_a,
                     const int* __restrict__ len_b, int* __restrict__ out, int n, int L,
                     bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Cells = WfCells<T, P>;
  using V = typename Cells::V;
  constexpr int kRows = P * kWarp / G;  // row pairs a warp
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWfWarps + warp) * kRows;
  if (r0 >= n) return;
  const int rows = (int)min((long long)kRows, (long long)n - r0);
  const T* staged = stage_rows<T>(smem + (size_t)warp * stage_bytes<T>(kRows, L), a, b, stride_a,
                                  stride_b, r0, rows, L, packed, wl);
  __syncwarp();

  // every lane stays to the end: the shuffles take the whole warp
  const int lane = wl % G, slot = wl / G;
  const T* sa[P];
  const T* sb[P];
  int cap_j[P], cap_i[P], res[P];
  bool writes[P];
  int steps = 0;
#pragma unroll
  for (int h = 0; h < P; ++h) {
    const int k = slot * P + h;  // the row pair's place in the warp
    const bool live = k < rows;
    sa[h] = staged + 2LL * L * (live ? k : 0);
    sb[h] = sa[h] + L;
    const int la = live ? len_a[r0 + k] : 0;
    const int lb = live ? len_b[r0 + k] : 0;
    const bool ok = la >= 0 && lb >= 0 && la <= L && lb <= L && la + lb >= 2;
    const bool dp = ok && la >= 1 && lb >= 1;
    const int owner = dp ? (la - 1) / K : 0;  // the lane whose strip holds row la
    // D[la][lb] is kept at column lb, step lb + owner - 1; rows with an empty
    // side, or out of range, take the first lane's direct value
    cap_j[h] = dp && lane == owner ? lb : -1;
    cap_i[h] = (la - 1) - owner * K;
    res[h] = !ok ? 0 : la == 0 ? lb : la;
    writes[h] = live && lane == owner;
    if (dp) steps = max(steps, lb + owner);
  }
  if constexpr (G > 1) steps = (int)__reduce_max_sync(kFull, (unsigned)steps);

  typename Cells::C ach[K];  // this lane's chars of a (its strip's rows)
  V col[K];                  // D[l*K + 1 + i][j] after column j
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int p = lane * K + i;
    ach[i] = Cells::chars(sa[0], sa[P - 1], min(p, L - 1));
    col[i] = Cells::splat(p + 1);
  }
  V prev_up = Cells::splat(0);  // D[l*K][j - 1]
  for (int s = 0; s < steps; ++s) {
    const int j = s - lane + 1;  // this lane's column
    V up;                        // D[l*K][j]
    if constexpr (G > 1) {
      up = __shfl_up_sync(kFull, col[K - 1], 1, G);
      if (lane == 0) up = Cells::splat(j);
    } else {
      up = Cells::splat(j);
    }
    if (j >= 1) {
      const int q = min(j - 1, L - 1);
      const typename Cells::C c = Cells::chars(sb[0], sb[P - 1], q);
      V t[K];
      t[0] = Cells::addmin(col[0], Cells::diag(prev_up, ach[0], c));
#pragma unroll
      for (int i = 1; i < K; ++i) t[i] = Cells::addmin(col[i], Cells::diag(col[i - 1], ach[i], c));
      col[0] = Cells::addmin(up, t[0]);
#pragma unroll
      for (int i = 1; i < K; ++i) col[i] = Cells::addmin(col[i - 1], t[i]);
      wf_keep<Cells>(col, j, cap_j[0], cap_i[0], 0, res[0]);
      if constexpr (P == 2) wf_keep<Cells>(col, j, cap_j[1], cap_i[1], 1, res[1]);
    }
    prev_up = up;
  }
  if (writes[0]) out[r0 + slot * P] = res[0];
  if constexpr (P == 2)
    if (writes[1]) out[r0 + slot * P + 1] = res[1];
}

// The instantiation for width L (1..512): G = 1 with K = 8 or 16 up to 16
// chars, else the least power of two G with 16G >= L and K = 12 or 16; two
// row pairs a lane on int8 rows there.
template <typename T, int G, int K>
cudaError_t wavefront_run(const T* a, const T* b, long long sa, long long sb, const int* la,
                          const int* lb, int* out, int n, int L, cudaStream_t stream) {
  constexpr int P = sizeof(T) == 1 && G > 1 ? 2 : 1;
  constexpr int kRows = P * kWarp / G;
  const bool packed = b == a + L && sa == 2LL * L && sb == 2LL * L;
  const int rows_per_block = kWfWarps * kRows;
  const int smem = kWfWarps * stage_bytes<T>(kRows, L);  // under 17 KB: no attribute needed
  const auto kernel = wavefront_kernel<T, G, K, P>;
  kernel<<<(n + rows_per_block - 1) / rows_per_block, kWfThreads, smem, stream>>>(
      a, b, sa, sb, la, lb, out, n, L, packed);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t wavefront_strip(const T* a, const T* b, long long sa, long long sb, const int* la,
                            const int* lb, int* out, int n, int L, cudaStream_t stream) {
  if (L <= 12 * G) return wavefront_run<T, G, 12>(a, b, sa, sb, la, lb, out, n, L, stream);
  return wavefront_run<T, G, 16>(a, b, sa, sb, la, lb, out, n, L, stream);
}

template <typename T>
cudaError_t wavefront_select(const void* a, const void* b, long long sa, long long sb,
                             const int* la, const int* lb, int* out, int n, int L,
                             cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  if (L <= 8) return wavefront_run<T, 1, 8>(ta, tb, sa, sb, la, lb, out, n, L, stream);
  if (L <= 16) return wavefront_run<T, 1, 16>(ta, tb, sa, sb, la, lb, out, n, L, stream);
  if (L <= 32) return wavefront_strip<T, 2>(ta, tb, sa, sb, la, lb, out, n, L, stream);
  if (L <= 64) return wavefront_strip<T, 4>(ta, tb, sa, sb, la, lb, out, n, L, stream);
  if (L <= 128) return wavefront_strip<T, 8>(ta, tb, sa, sb, la, lb, out, n, L, stream);
  if (L <= 256) return wavefront_strip<T, 16>(ta, tb, sa, sb, la, lb, out, n, L, stream);
  return wavefront_strip<T, 32>(ta, tb, sa, sb, la, lb, out, n, L, stream);
}

}  // namespace
}  // namespace strsim

// Row r of a starts at a + r * stride_a elements (likewise b), so a and b may
// be column slices of one packed [n, 2L] tile; a row whose lengths are not in
// 0..L gives 0.
// elem_bytes: 1 (int8) or 4 (int32). One launch; returns its cudaError_t (0
// on success).
extern "C" int strsim_levenshtein_wavefront(const void* a, const void* b,
                                            long long stride_a, long long stride_b,
                                            const void* len_a, const void* len_b,
                                            void* out, int n, int L, int elem_bytes,
                                            void* stream) {
  using namespace strsim;
  if (n <= 0 || L <= 0 || L > kWfMaxWidth) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  const int* lb = static_cast<const int*>(len_b);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 1)
    return (int)wavefront_select<int8_t>(a, b, stride_a, stride_b, la, lb, o, n, L, s);
  if (elem_bytes == 4)
    return (int)wavefront_select<int32_t>(a, b, stride_a, stride_b, la, lb, o, n, L, s);
  return (int)cudaErrorInvalidValue;
}
