// A register-tiled 64 x 64 product tile on the CUDA cores, shared by the
// triangular kernels (trsm.cu) and the blocked Cholesky (cholesky.cu).
//
// 256 threads, each holding a 4 x 4 block of the output in registers; the
// operands go through shared memory in 16-deep slices, the next slice is
// loaded into registers while the current one is multiplied, and a thread
// reads its four A and four B values of a step with two vector loads, so a
// step is 16 FMA per 2-3 shared-memory wavefronts. FMA in the operands' own
// type (f32 or f64; no TF32).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // output tile edge
constexpr int TILE_K = 16;        // depth slice
constexpr int TILE_THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int TILE_PAD = 4;       // keeps shared rows 16-byte aligned

__device__ __forceinline__ void lds4(float (&v)[4], const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void lds4(double (&v)[4], const double* p) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T>
struct TileSmem {
  __align__(16) T a[2][TILE_K][TILE + TILE_PAD];
  __align__(16) T b[2][TILE_K][TILE + TILE_PAD];
};

// acc[q][w] += sum_{p in [k_lo, k_hi)} A(4 ty + q, p) B(p, 4 tx + w) with
// ty = tid / 16, tx = tid % 16. A(r, p) = a[r * lda + p] (a[p * lda + r]
// with TA), zero for r >= a_rows; B(p, c) = b[p * ldb + c] (b[c * ldb + p]
// with TB), zero for c >= b_cols. Each loader walks its operand along the
// contiguous index. Ends with a block barrier, so the caller may reuse sm.
// The operands may be written by the same kernel between calls, so they
// are not __restrict__ (no read-only cache path).
template <typename T, bool TA, bool TB>
__device__ void gemm_tile(T (&acc)[4][4], TileSmem<T>& sm, const T* a,
                          int lda, int a_rows, const T* b, int ldb,
                          int b_cols, int k_lo, int k_hi) {
  if (k_lo >= k_hi) return;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // transposed: 64 consecutive threads along the tile, 4 slice rows a pass;
  // else 16 consecutive threads along the slice, 16 tile rows a pass
  const int ar = TA ? tid % TILE : tid / TILE_K;
  const int ap = TA ? tid / TILE : tid % TILE_K;
  const int bc = TB ? tid / TILE_K : tid % TILE;
  const int bp = TB ? tid % TILE_K : tid / TILE;
  T ra[4], rb[4];
  auto load = [&](int p0) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = TA ? ar : ar + 16 * u;
      const int p = p0 + (TA ? ap + 4 * u : ap);
      ra[u] = (r < a_rows && p < k_hi)
                  ? (TA ? a[(size_t)p * lda + r] : a[(size_t)r * lda + p])
                  : T(0);
      const int c = TB ? bc + 16 * u : bc;
      const int q = p0 + (TB ? bp : bp + 4 * u);
      rb[u] = (c < b_cols && q < k_hi)
                  ? (TB ? b[(size_t)c * ldb + q] : b[(size_t)q * ldb + c])
                  : T(0);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (TA) {
        sm.a[buf][ap + 4 * u][ar] = ra[u];
      } else {
        sm.a[buf][ap][ar + 16 * u] = ra[u];
      }
      if (TB) {
        sm.b[buf][bp][bc + 16 * u] = rb[u];
      } else {
        sm.b[buf][bp + 4 * u][bc] = rb[u];
      }
    }
  };
  load(k_lo);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int p0 = k_lo; p0 < k_hi; p0 += TILE_K) {
    const bool more = p0 + TILE_K < k_hi;
    if (more) load(p0 + TILE_K);
#pragma unroll
    for (int kk = 0; kk < TILE_K; ++kk) {
      T av[4], bv[4];
      lds4(av, &sm.a[buf][kk][4 * ty]);
      lds4(bv, &sm.b[buf][kk][4 * tx]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[q][w] += av[q] * bv[w];
      }
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
}

}  // namespace
