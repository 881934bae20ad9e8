// Three A/B probes of the multiset intersection K3 (multiset.cu), K20-K22,
// a thread a row, every loop unrolled to a width fixed when the kernel is
// built (the narrow ladder 7, 15, 23, 31, 47, 63).
//
// Replaces the TPU probes of tools/ (each file's kernel and wrapper):
//   K20 ab_multiset_pallas.py _kernel :39 (launched at :84) and
//       ab_multiset_r3.py _kernel_tree :40 and _kernel_astype :66 (launched
//       at :184): unrolled_kernel<T, L, Accum>, the three bodies differing
//       only in how a compare is accumulated (Accum: select, tree, astype)
//   K21 ab_multiset_r3.py _kernel_swar :89: swar_kernel<L>, int8 only
//   K22 ab_multiset_r3.py _kernel_blocked :140: blocked_kernel<T, L, GI>
// Contract of the probes, as strsim_tpu_torch/probes/multiset.py's plain
// versions: for every a-position i < L, cnt_b(i) = #{j < L : b_j == a_i}
// and occ(i) = #{k < i : a_k == a_i}; inter counts the i < la with
// occ(i) < cnt_b(i). The kernels read la only, as the TPU bodies do: b's
// tail past lb holds PAD_B (-2), which no char of a equals, so it never
// matches. K21 compares bytes with a's chars below 0 read as 255 and b's as
// 254 (the tool's pads), so those never match either.
// Repaired here, not carried over: the TPU's _kernel_swar leaves the unused
// bytes of b's short last word at 0, so a NUL a-char counted them as
// matches (every ladder width is 3 mod 4, so that word is always short).
// K21 fills them with 254, b's pad byte.
//
// What bounds them on this card: the compares. The bodies make L^2 +
// L(L - 1) / 2 of them a row, about two operations each (a compare and an
// add): about 700 operations a row at w15 and 11,800 at w63, against two
// operations a char for the histogram that ops/roofline.py counts as the
// function's floor. K21 tests four chars a word in about six operations,
// ceil(L / 4) words of b and ceil(i / 4) of a for every i.
//
// The design: one thread a row, 128 threads a block. A warp stages its 32
// rows in shared memory once with coalesced 16-byte loads
// (lanes.cuh:stage_rows; K3's earlier thread-a-row form spent its time on
// one-byte loads that touch 32 rows each). Every loop is unrolled to the
// compile-time L, as the TPU's static Python loops are (static_for over the
// a-positions, #pragma unroll inside), so each index is known when the
// kernel is built:
//   * K20 and K22 hold both rows in registers up to w31. Above it two rows
//     of int32 chars do not fit beside the counters (126 registers at w63),
//     so they read each char from shared memory where it is used (volatile,
//     so that the compiler cannot hoist all of them into registers and
//     spill); K22 then reads each b char once for GI a-positions, as the
//     TPU's register blocking does.
//   * K21 packs each side into ceil(L / 4) words (at most 16) in registers.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "lanes.cuh"

namespace strsim {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
// Blocks an SM holds: shared memory allows 3 of int32 w63 (64.6 KB a
// block), more below; 4 leave 128 registers a thread for the two rows of
// w31 in registers beside the tree's terms.
constexpr int kBlocksPerSm = 4;
constexpr int kRegisterWidth = 31;  // widths up to this hold both rows in registers

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, in order
template <typename F, int... Is>
__device__ __forceinline__ void static_for_seq(F&& f, std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}
template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_seq(f, std::make_integer_sequence<int, N>{});
}

// The warp's rows [r0, r0 + 32) staged; this lane's row, or null past the
// last row.
template <typename T>
__device__ __forceinline__ const T* stage_warp(unsigned char* smem, const T* a, const T* b,
                                               long long sa, long long sb, int n, int L,
                                               bool packed, long long& r) {
  const int warp = threadIdx.x / kWarp, wl = threadIdx.x % kWarp;
  const long long r0 = ((long long)blockIdx.x * kWarps + warp) * kWarp;
  if (r0 >= n) return nullptr;
  const int rows = (int)min((long long)kWarp, (long long)n - r0);
  const T* staged = stage_rows<T>(smem + (size_t)warp * stage_bytes<T>(kWarp, L), a, b, sa, sb,
                                  r0, rows, L, packed, wl);
  __syncwarp();
  r = r0 + wl;
  return wl < rows ? staged + 2LL * L * wl : nullptr;
}

// One side's L chars: in registers up to kRegisterWidth, else read from the
// staged row at each use.
template <typename T, int L>
struct Chars {
  static constexpr bool kInRegisters = L <= kRegisterWidth;
  int reg[kInRegisters ? L : 1];
  const volatile T* row;

  __device__ __forceinline__ explicit Chars(const T* s) : row(s) {
    if constexpr (kInRegisters) {
#pragma unroll
      for (int k = 0; k < L; ++k) reg[k] = s[k];
    }
  }
  __device__ __forceinline__ int operator[](int k) const {
    if constexpr (kInRegisters) return reg[k];
    else return row[k];
  }
};

// --- K20: the three ways to accumulate a compare -----------------------------

enum Accum { kSelect = 0, kTree = 1, kAstype = 2 };  // the wrapper's mode index

// Balanced pairwise sums of t[0 .. N), adjacent pairs first and an odd last
// term carried up (_kernel_tree's tree_sum)
template <int N, int M>
__device__ __forceinline__ int tree_sum(int (&t)[M]) {
  if constexpr (N <= 1) {
    return t[0];
  } else {
#pragma unroll
    for (int p = 0; p < N / 2; ++p) t[p] = t[2 * p] + t[2 * p + 1];
    if constexpr (N % 2) t[N / 2] = t[N - 1];
    return tree_sum<(N + 1) / 2>(t);
  }
}

// #{k < limit : x[k] == c} over the N chars of x, accumulated as mode A
// does. `limit` is a constant where this is inlined (L, or an unrolled i),
// so the terms k >= limit fold away: each mode keeps the TPU body's shape
// over the first `limit` terms (the tree's zero terms only carry sums up).
template <Accum A, int N, typename Row>
__device__ __forceinline__ int count_equal(const Row& x, int c, int limit) {
  if constexpr (A == kTree) {
    int t[N];
#pragma unroll
    for (int k = 0; k < N; ++k) t[k] = k < limit && x[k] == c ? 1 : 0;
    return tree_sum<N>(t);
  } else {
    int s = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= limit) continue;
      if constexpr (A == kSelect) s += x[k] == c ? 1 : 0;  // where(eq, 1, 0)
      else s += (int)(x[k] == c);                          // eq.astype(i32)
    }
    return s;
  }
}

template <typename T, int L, Accum A>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    unrolled_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                    long long stride_b, const int* __restrict__ len_a, int* __restrict__ out,
                    int n, bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long r;
  const T* sa = stage_warp<T>(smem, a, b, stride_a, stride_b, n, L, packed, r);
  if (sa == nullptr) return;
  const Chars<T, L> ca(sa), cb(sa + L);
  const int la = len_a[r];
  int inter = 0;
  static_for<L>([&](auto ii) {
    constexpr int i = decltype(ii)::value;
    const int c = ca[i];
    const int cnt = count_equal<A, L>(cb, c, L);
    const int occ = count_equal<A, L>(ca, c, i);
    if constexpr (A == kAstype) inter += (int)(occ < cnt && i < la);
    else inter += occ < cnt && i < la ? 1 : 0;
  });
  out[r] = inter;
}

// --- K21: four chars a word ------------------------------------------------------

// 0x80 in each zero byte of x, exact (no carry crosses a byte)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// Byte p of word w is char 4w + p of the row, chars below 0 and the bytes
// past L `pad`.
template <int L>
__device__ __forceinline__ void pack_row(const int8_t* s, uint32_t pad, uint32_t (&w)[(L + 3) / 4]) {
#pragma unroll
  for (int k = 0; k < (L + 3) / 4; ++k) {
    uint32_t x = 0u;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = 4 * k + p;
      const uint32_t c = i < L && s[i] >= 0 ? (uint32_t)s[i] : pad;
      x |= c << (8 * p);
    }
    w[k] = x;
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    swar_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, long long stride_a,
                long long stride_b, const int* __restrict__ len_a, int* __restrict__ out, int n,
                bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int W4 = (L + 3) / 4;
  long long r;
  const int8_t* sa = stage_warp<int8_t>(smem, a, b, stride_a, stride_b, n, L, packed, r);
  if (sa == nullptr) return;
  uint32_t aw[W4], bw[W4];
  pack_row<L>(sa, 0xFFu, aw);      // a's bytes past L are never read
  pack_row<L>(sa + L, 0xFEu, bw);  // b's: 254, so that a NUL a-char finds no match there
  const int la = len_a[r];
  int inter = 0;
  static_for<L>([&](auto ii) {
    constexpr int i = decltype(ii)::value;
    const uint32_t aa = ((aw[i / 4] >> (8 * (i % 4))) & 0xFFu) * 0x01010101u;
    uint32_t acc_b = 0u;  // a count in each byte, at most W4 <= 16
#pragma unroll
    for (int w = 0; w < W4; ++w) acc_b += zero_bytes(bw[w] ^ aa) >> 7;
    uint32_t acc_a = 0u;
#pragma unroll
    for (int w = 0; w < (i + 3) / 4; ++w) {  // the words that hold the k < i
      uint32_t z = zero_bytes(aw[w] ^ aa) >> 7;
      if (4 * (w + 1) > i) z &= (1u << (8 * (i % 4))) - 1u;  // only bytes k < i
      acc_a += z;
    }
    const int cnt = (int)((acc_b * 0x01010101u) >> 24);  // the four bytes summed, <= L
    const int occ = (int)((acc_a * 0x01010101u) >> 24);
    inter += (int)(occ < cnt && i < la);
  });
  out[r] = inter;
}

// --- K22: GI a-positions for each char read ----------------------------------------

template <typename T, int L, int GI>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    blocked_kernel(const T* __restrict__ a, const T* __restrict__ b, long long stride_a,
                   long long stride_b, const int* __restrict__ len_a, int* __restrict__ out,
                   int n, bool packed) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long r;
  const T* sa = stage_warp<T>(smem, a, b, stride_a, stride_b, n, L, packed, r);
  if (sa == nullptr) return;
  const Chars<T, L> ca(sa), cb(sa + L);
  const int la = len_a[r];
  int inter = 0;
  static_for<(L + GI - 1) / GI>([&](auto blk) {
    constexpr int i0 = GI * decltype(blk)::value;
    constexpr int G = GI < L - i0 ? GI : L - i0;  // the block's a-positions
    int ai[G], cnt[G], occ[G];
#pragma unroll
    for (int g = 0; g < G; ++g) ai[g] = ca[i0 + g], cnt[g] = occ[g] = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int bj = cb[j];  // one read, G compares
#pragma unroll
      for (int g = 0; g < G; ++g) cnt[g] += (int)(bj == ai[g]);
    }
#pragma unroll
    for (int k = 0; k < i0 + G - 1; ++k) {  // k < the block's last i
      const int ak = ca[k];
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (k < i0 + g) occ[g] += (int)(ak == ai[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) inter += (int)(occ[g] < cnt[g] && i0 + g < la);
  });
  out[r] = inter;
}

// --- launches --------------------------------------------------------------------

template <typename T, typename K>
cudaError_t launch_rows(K kernel, const void* a, const void* b, long long sa, long long sb,
                        const int* la, int* out, int n, int L, cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  const int smem = kWarps * stage_bytes<T>(kWarp, L);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool packed = tb == ta + L && sa == 2LL * L && sb == 2LL * L;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(ta, tb, sa, sb, la, out, n,
                                                                    packed);
  return cudaGetLastError();
}

// f(std::integral_constant<int, L>) for L on the narrow ladder; any other
// width is refused
template <typename F>
cudaError_t on_ladder(int L, F&& f) {
  switch (L) {
    case 7: return f(std::integral_constant<int, 7>{});
    case 15: return f(std::integral_constant<int, 15>{});
    case 23: return f(std::integral_constant<int, 23>{});
    case 31: return f(std::integral_constant<int, 31>{});
    case 47: return f(std::integral_constant<int, 47>{});
    case 63: return f(std::integral_constant<int, 63>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(T{}) for the tile's char type: elem_bytes 1 (int8) or 4 (int32)
template <typename F>
cudaError_t on_type(int elem_bytes, F&& f) {
  if (elem_bytes == 1) return f(int8_t{});
  if (elem_bytes == 4) return f(int32_t{});
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace strsim

// Row r of a starts at a + r * stride_a elements (likewise b), so a and b may
// be column slices of one packed [n, 2L] tile; L on the narrow ladder (7,
// 15, 23, 31, 47, 63). Each returns the launch's cudaError_t (0 on success).

// K20. elem_bytes: 1 (int8) or 4 (int32); mode: 0 select, 1 tree, 2 astype.
extern "C" int strsim_probe_multiset_unrolled(const void* a, const void* b, long long stride_a,
                                              long long stride_b, const void* len_a, void* out,
                                              int n, int L, int elem_bytes, int mode,
                                              void* stream) {
  using namespace strsim;
  if (n <= 0 || mode < kSelect || mode > kAstype) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)on_type(elem_bytes, [&](auto t) {
    using T = decltype(t);
    return on_ladder(L, [&](auto w) {
      constexpr int W = decltype(w)::value;
      if (mode == kSelect)
        return launch_rows<T>(unrolled_kernel<T, W, kSelect>, a, b, stride_a, stride_b, la, o, n, W, s);
      if (mode == kTree)
        return launch_rows<T>(unrolled_kernel<T, W, kTree>, a, b, stride_a, stride_b, la, o, n, W, s);
      return launch_rows<T>(unrolled_kernel<T, W, kAstype>, a, b, stride_a, stride_b, la, o, n, W, s);
    });
  });
}

// K21, int8 tiles only.
extern "C" int strsim_probe_multiset_swar(const void* a, const void* b, long long stride_a,
                                          long long stride_b, const void* len_a, void* out, int n,
                                          int L, void* stream) {
  using namespace strsim;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  return (int)on_ladder(L, [&](auto w) {
    constexpr int W = decltype(w)::value;
    return launch_rows<int8_t>(swar_kernel<W>, a, b, stride_a, stride_b,
                               static_cast<const int*>(len_a), static_cast<int*>(out), n, W,
                               static_cast<cudaStream_t>(stream));
  });
}

// K22. elem_bytes as K20's; gi: 4 or 8 a-positions for each char read.
extern "C" int strsim_probe_multiset_blocked(const void* a, const void* b, long long stride_a,
                                             long long stride_b, const void* len_a, void* out,
                                             int n, int L, int elem_bytes, int gi, void* stream) {
  using namespace strsim;
  if (n <= 0 || (gi != 4 && gi != 8)) return (int)cudaErrorInvalidValue;
  const int* la = static_cast<const int*>(len_a);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)on_type(elem_bytes, [&](auto t) {
    using T = decltype(t);
    return on_ladder(L, [&](auto w) {
      constexpr int W = decltype(w)::value;
      if (gi == 4)
        return launch_rows<T>(blocked_kernel<T, W, 4>, a, b, stride_a, stride_b, la, o, n, W, s);
      return launch_rows<T>(blocked_kernel<T, W, 8>, a, b, stride_a, stride_b, la, o, n, W, s);
    });
  });
}
