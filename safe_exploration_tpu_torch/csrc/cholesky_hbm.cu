// Right-looking block Cholesky for large matrices, batched over matrices:
// the tier above cholesky.cu's n <= 1024, one launch per 64-wide panel.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/cholesky_hbm.py
// (_chol_hbm_kernel, reached through cholesky_hbm). Same contract: A (e, n, n)
// SPD -> L (e, n, n) lower with L L^T = A and zeros above the diagonal, only
// the lower triangle of A is read, any n >= 1 (the ragged last panel is
// masked, nothing is padded), and a non-positive pivot gives NaN from that
// column on, which every later panel inherits through its update; the
// kernel never raises and never clamps.
//
// Algorithm: right-looking over 64-wide panels with a one-panel lookahead.
// Launch k (k = 0 .. ceil(n / 64) - 1, one launch for all e matrices) runs
// two kinds of CTA, and both read only panel k - 1, which launch k - 1
// finished:
//   column CTAs (the lowest blockIdx, one per 64-row chunk of the strip
//     below the diagonal block of panel k; one if the panel has no strip):
//     each applies panel k - 1's rank-64 update to the diagonal block and
//     to its own chunk (two 64 x 64 x 64 products, gemm_tile.cuh), factors
//     the diagonal block in shared memory (factor_smem.cuh, redundantly in
//     every column CTA, as cholesky.cu's chol_panel does), solves its chunk
//     against that factor (four threads per row, the row's value of each
//     column passed by shuffles) and writes its chunk of L and the zeros of
//     the block mirrored above the diagonal;
//   update CTAs: panel k - 1's update of every 64 x 64 tile of the lower
//     triangle right of panel k (column blocks k + 1 ..), one CTA per tile
//     of the tile triangle, in place (gemm_tile.cuh).
// So the pivot chain of panel k runs beside the trailing update of panel
// k - 1 instead of after it. No CTA writes a block that another CTA of its
// launch reads (CTAs of one grid run in no fixed order): every column CTA
// reads the unfactored diagonal block of panel k, so the factored block
// goes to a per-matrix stage buffer, written by column CTA 0 of launch k and
// copied into L by column CTA 0 of launch k + 1, which no other CTA of that
// launch reads; the last panel, which has no strip and one column CTA,
// writes its block directly. Blocks stand in A until their first update
// (column blocks 0 and 1) and in L after.
// FMA on the CUDA cores in the matrices' own type (f32 or f64; no TF32, no
// library call).
//
// What bounds it on an H100: n^3 / 3 flops per matrix (5.7 GFLOP for e = 2 at
// n = 2048, 0.085 ms at the 67 TFLOP/s f32 peak) against 2 e n^2 words of
// traffic; the bound is operations. What stands between this kernel and that
// bound: the chain of n / 64 dependent launches, each at least one panel's
// products, factorization and solve long (the column CTAs), and a CUDA-core
// product for the O(n^3) update. Tensor-core tiles (DMMA in f64), TMA loads
// and larger update tiles are later work.

#include <cuda_runtime.h>
#include <math.h>

#include "factor_smem.cuh"
#include "gemm_tile.cuh"

namespace {

constexpr int P = TILE;             // panel width
constexpr int LDP = P + 1;          // padded row stride of the shared blocks
constexpr int ROW_T = 4;            // threads per strip row in the solve
static_assert(P * ROW_T == TILE_THREADS, "one strip row per 4 threads");

// Dynamic shared memory of one CTA: the product's tiles, then the column
// CTA's diagonal block s, strip chunk xs and diagonal reciprocals rd; the
// 16 x 64 panel copy of factor_smem reuses the product's tiles.
template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(TileSmem<T>) + (2 * P * LDP + P) * sizeof(T);
}

template <typename T>
__device__ void column_cta(const T* src, T* l, T* stage, unsigned char* raw,
                           int n, int k, int chunk) {
  TileSmem<T>& tsm = *reinterpret_cast<TileSmem<T>*>(raw);
  T (*s)[LDP] = reinterpret_cast<T (*)[LDP]>(raw + sizeof(TileSmem<T>));
  T (*xs)[LDP] = s + P;
  T* rd = &s[0][0] + 2 * P * LDP;
  T* pt = reinterpret_cast<T*>(raw);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = k * P, pk0 = k0 - P;
  const int kb = min(P, n - k0);
  const bool strip = k0 + P < n;      // then kb == P
  const int r0 = k0 + P * (1 + chunk);

  // the block of panel k - 1, factored by the launch before
  if (chunk == 0 && k > 0) {
    for (int idx = tid; idx < P * P; idx += TILE_THREADS) {
      const int i = idx / P, j = idx % P;
      l[(size_t)(pk0 + i) * n + pk0 + j] = j <= i ? stage[idx] : T(0);
    }
  }
  // S_kk = A_kk - L_k,k-1 L_k,k-1^T (lower), the chunk likewise
  T acc[4][4] = {};
  if (k > 0) {
    gemm_tile<T, false, true>(acc, tsm, l + (size_t)k0 * n + pk0, n, kb,
                              l + (size_t)k0 * n + pk0, n, kb, 0, P);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 4 * ty + q;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = 4 * tx + w;
      if (i < kb && j <= i) {
        s[i][j] = src[(size_t)(k0 + i) * n + k0 + j] - acc[q][w];
      }
    }
  }
  if (strip) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[q][w] = T(0);
    }
    if (k > 0) {
      gemm_tile<T, false, true>(acc, tsm, l + (size_t)r0 * n + pk0, n, n - r0,
                                l + (size_t)k0 * n + pk0, n, P, 0, P);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * ty + q;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int j = 4 * tx + w;
        xs[i][j] = r0 + i < n ? src[(size_t)(r0 + i) * n + k0 + j] - acc[q][w]
                              : T(0);
      }
    }
  }
  __syncthreads();
  factor_smem<T>(&s[0][0], LDP, kb, pt, P, rd);   // ends on a barrier

  if (!strip) {   // the last panel: its only CTA writes the block itself
    for (int idx = tid; idx < P * P; idx += TILE_THREADS) {
      const int i = idx / P, j = idx % P;
      if (i < kb && j < kb) {
        l[(size_t)(k0 + i) * n + k0 + j] = j <= i ? s[i][j] : T(0);
      }
    }
    return;
  }
  if (chunk == 0) {
    for (int idx = tid; idx < P * P; idx += TILE_THREADS) {
      const int i = idx / P, j = idx % P;
      stage[idx] = j <= i ? s[i][j] : T(0);
    }
  }
  // x = S_i L_kk^-T, row by row: thread t of a row owns columns t, t + 4,
  // ..; column c's value leaves its owner by a shuffle inside the row's
  // four lanes and updates the columns after it
  {
    const int row = tid / ROW_T, t = tid % ROW_T;
    const int base = (tid & 31) & ~(ROW_T - 1);
    T x[P / ROW_T];
#pragma unroll
    for (int m = 0; m < P / ROW_T; ++m) x[m] = xs[row][ROW_T * m + t];
#pragma unroll
    for (int c = 0; c < P; ++c) {
      const T v = __shfl_sync(FULL, x[c / ROW_T] * rd[c], base | (c % ROW_T));
      if (t == c % ROW_T) x[c / ROW_T] = v;
#pragma unroll
      for (int m = c / ROW_T; m < P / ROW_T; ++m) {
        if (ROW_T * m + t > c) x[m] -= v * s[ROW_T * m + t][c];
      }
    }
#pragma unroll
    for (int m = 0; m < P / ROW_T; ++m) xs[row][ROW_T * m + t] = x[m];
  }
  __syncthreads();
  const int cols = min(P, n - r0);
  for (int idx = tid; idx < P * P; idx += TILE_THREADS) {
    const int i = idx / P, j = idx % P;
    if (i < cols) l[(size_t)(r0 + i) * n + k0 + j] = xs[i][j];
    if (j < cols) l[(size_t)(k0 + i) * n + r0 + j] = T(0);
  }
}

// Tile t of the tile triangle right of panel k: L_ij = S_ij - L_i,k-1
// L_j,k-1^T on its lower part; an element is read and written by the same
// thread, so src may be l.
template <typename T>
__device__ void update_cta(const T* src, T* l, unsigned char* raw, int n,
                           int k, int t) {
  TileSmem<T>& tsm = *reinterpret_cast<TileSmem<T>*>(raw);
  int bi = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int pk0 = (k - 1) * P;
  const int i0 = (k + 1) * P + P * bi, j0 = (k + 1) * P + P * bj;
  T acc[4][4] = {};
  gemm_tile<T, false, true>(acc, tsm, l + (size_t)i0 * n + pk0, n, n - i0,
                            l + (size_t)j0 * n + pk0, n, n - j0, 0, P);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = i0 + 4 * ty + q;
    if (i >= n) continue;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int j = j0 + 4 * tx + w;
      if (j <= i) {
        const size_t at = (size_t)i * n + j;
        l[at] = src[at] - acc[q][w];
      }
    }
  }
}

// Launch k: e * n_col column CTAs, then e * n_upd update CTAs (one 1-D grid,
// so that every matrix's column CTAs are scheduled before any update CTA).
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
chol_hbm_step(const T* a_all, T* l_all, T* stage_all, int e, int n, int k,
              int n_col, int n_upd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t nn = (size_t)n * n;
  int id = blockIdx.x;
  if (id < e * n_col) {
    const int m = id / n_col;
    column_cta<T>((k <= 1 ? a_all : l_all) + m * nn, l_all + m * nn,
                  stage_all + (size_t)m * P * P, smem_raw, n, k, id % n_col);
    return;
  }
  id -= e * n_col;
  const int m = id / n_upd;
  update_cta<T>((k == 1 ? a_all : l_all) + m * nn, l_all + m * nn, smem_raw, n,
                k, id % n_upd);
}

template <typename T>
int run(const T* a, T* l, T* stage, int e, int n, cudaStream_t st) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      chol_hbm_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int panels = (n + P - 1) / P;
  for (int k = 0; k < panels; ++k) {
    const int strips = panels - 1 - k;     // 64-row chunks below panel k
    const int n_col = strips > 0 ? strips : 1;
    const int n_upd = k > 0 ? strips * (strips + 1) / 2 : 0;
    const long long grid = (long long)e * (n_col + n_upd);
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    chol_hbm_step<T><<<(unsigned)grid, TILE_THREADS, bytes, st>>>(
        a, l, stage, e, n, k, n_col, n_upd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// The panel width; the wrapper sizes the stage buffer with it.
extern "C" int cholesky_hbm_panel() { return P; }

// a (e, n, n) input, l (e, n, n) output (must not alias a); stage a
// workspace of e * 64 * 64 elements.
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int cholesky_hbm(const void* a, void* l, void* stage, int e, int n,
                            int is_f64, void* stream) {
  if (n < 1 || e < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return run<double>(static_cast<const double*>(a), static_cast<double*>(l),
                       static_cast<double*>(stage), e, n, s);
  }
  return run<float>(static_cast<const float*>(a), static_cast<float*>(l),
                    static_cast<float*>(stage), e, n, s);
}
