// Blocked triangular solve with many right-hand sides, batched over matrices.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/trsm.py
// (_trsm_kernel, reached through trsm_lower_blocked and solve_psd_blocked):
// X = L^-1 B (forward) or X = L^-T B (backward, transpose=1) for lower L
// (e, n, n) and B (e, n, m). Only the lower triangle of L is read.
//
// Algorithm: each CTA owns 32 right-hand-side columns of one matrix and
// walks the 32-row blocks in solve order (top-down, or bottom-up for L^T).
// For a row block it first subtracts the contribution of every row already
// solved, a (32 x p) by (p x 32) product staged through shared memory in
// 32-wide chunks, then substitutes through the 32x32 diagonal block in
// shared memory, one row per step, all 32 columns in parallel.
//
// What bounds it on an H100: the refit's solves are small (n = 128: L^-1
// is 2 n^3/3 ~ 1.4 MFLOP per dim; beta is an m = 1 matrix-vector chain), so
// the bound is the length of the dependent chain of row blocks (n/32 steps,
// each a few shared-memory round trips), not bytes (n^2 + 2nm words) or
// flops. What the design does about it: columns are independent, so every
// 32-column group of every matrix is its own CTA and the chain never
// crosses CTAs; the product part is shared-memory tiled. With m = 1 only
// one column of the 32 is live: simple first, as the refit's beta solve is
// two such chains of n/32 steps.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 32;  // row-block height and columns per CTA

template <typename T>
__global__ void __launch_bounds__(TB * TB)
trsm_kernel(const T* __restrict__ l, const T* __restrict__ b,
            T* __restrict__ x, int n, int m, int transpose) {
  __shared__ T ls[TB][TB + 1];
  __shared__ T xs[TB][TB + 1];
  __shared__ T rs[TB][TB + 1];
  __shared__ T ld[TB][TB + 1];

  const int e = blockIdx.y;
  const T* le = l + (size_t)e * n * n;
  const T* be = b + (size_t)e * n * m;
  T* xe = x + (size_t)e * n * m;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * TB + tx;
  const bool cv = c < m;
  const int nblk = (n + TB - 1) / TB;

  for (int s = 0; s < nblk; ++s) {
    const int blk = transpose ? nblk - 1 - s : s;
    const int r0 = blk * TB;
    const int rb = n - r0 < TB ? n - r0 : TB;
    const int row = r0 + ty;
    T acc = (row < n && cv) ? be[(size_t)row * m + c] : T(0);

    // rows already solved: [0, r0) forward, [r0 + rb, n) backward
    const int p_begin = transpose ? r0 + rb : 0;
    const int p_end = transpose ? n : r0;
    for (int p0 = p_begin; p0 < p_end; p0 += TB) {
      xs[ty][tx] =
          (p0 + ty < p_end && cv) ? xe[(size_t)(p0 + ty) * m + c] : T(0);
      if (transpose) {
        // ls[q][t] = L[p0 + q][r0 + t]  (= U[r0 + t][p0 + q], U = L^T)
        ls[ty][tx] = (p0 + ty < p_end && r0 + tx < n)
                         ? le[(size_t)(p0 + ty) * n + r0 + tx]
                         : T(0);
      } else {
        // ls[t][q] = L[r0 + t][p0 + q]
        ls[ty][tx] = (row < n && p0 + tx < p_end)
                         ? le[(size_t)row * n + p0 + tx]
                         : T(0);
      }
      __syncthreads();
      if (transpose) {
        for (int q = 0; q < TB; ++q) acc -= ls[q][ty] * xs[q][tx];
      } else {
        for (int q = 0; q < TB; ++q) acc -= ls[ty][q] * xs[q][tx];
      }
      __syncthreads();
    }
    rs[ty][tx] = acc;
    // diagonal block ld[i][j] = L[r0 + i][r0 + j]
    ld[ty][tx] = (row < n && r0 + tx < n) ? le[(size_t)row * n + r0 + tx]
                                          : T(0);
    __syncthreads();
    if (!transpose) {
      for (int i = 0; i < rb; ++i) {
        if (ty == i) rs[i][tx] = rs[i][tx] / ld[i][i];
        __syncthreads();
        if (ty > i && ty < rb) rs[ty][tx] -= ld[ty][i] * rs[i][tx];
        __syncthreads();
      }
    } else {
      for (int i = rb - 1; i >= 0; --i) {
        if (ty == i) rs[i][tx] = rs[i][tx] / ld[i][i];
        __syncthreads();
        if (ty < i) rs[ty][tx] -= ld[i][ty] * rs[i][tx];
        __syncthreads();
      }
    }
    if (row < n && cv) xe[(size_t)row * m + c] = rs[ty][tx];
    __syncthreads();  // the next block reads these rows back from xe
  }
}

}  // namespace

// l (e, n, n) lower, b (e, n, m), x (e, n, m) output (must not alias b).
// Returns cudaGetLastError() (0 on success).
extern "C" int trsm_lower(const void* l, const void* b, void* x, int e, int n,
                          int m, int transpose, int is_f64, void* stream) {
  if (n < 1 || m < 1 || e < 1 || e > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(TB, TB);
  const dim3 grid((m + TB - 1) / TB, e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    trsm_kernel<double><<<grid, block, 0, s>>>(
        static_cast<const double*>(l), static_cast<const double*>(b),
        static_cast<double*>(x), n, m, transpose);
  } else {
    trsm_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(l), static_cast<const float*>(b),
        static_cast<float*>(x), n, m, transpose);
  }
  return (int)cudaGetLastError();
}
