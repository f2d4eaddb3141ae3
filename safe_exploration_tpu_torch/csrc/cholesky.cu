// Blocked right-looking lower Cholesky factorization, batched over matrices.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/cholesky.py
// (_chol_kernel with upper_chol_rows_ref / upper_tri_inv_rows_ref, reached
// through cholesky_blocked). Same contract: A (e, n, n) SPD -> L (e, n, n)
// lower with L L^T = A, only the lower triangle of A is read, and a
// non-positive pivot yields NaN (it does not raise) from that column on, so
// the GP refit's downstream finiteness checks catch a broken factor.
//
// Algorithm, per 32-wide panel k (host loop, one launch per step, every
// launch batched over the e matrices):
//   1. potrf_diag:  factor the 32x32 diagonal block in shared memory
//                   (unblocked right-looking, one CTA per matrix);
//   2. trsm_panel:  L_ik = A_ik L_kk^-T for the rows below, one thread per
//                   row, L_kk and 128 rows staged in shared memory;
//   3. syrk_update: A_ij -= L_ik L_jk^T on the trailing lower triangle,
//                   32x32 output tiles (upper tiles exit at once).
//
// What bounds it on an H100: neither bytes nor flops. n^3/3 flops
// (0.7 MFLOP at n=128, 45 MFLOP at n=512) and 2 n^2 words are microseconds
// of work, while the factorization is a chain of 3 n/32 dependent launches
// whose early steps occupy one SM per matrix: latency of the dependent
// chain is the bound. What the design does about it: it keeps every step
// small and batched over the output dims (one chain for all e matrices,
// not e chains), keeps the diagonal work in shared memory, and lets the
// O(n^3) part (syrk_update) spread over as many CTAs as the trailing matrix
// has tiles. Fusing the chain into fewer launches is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NB = 32;     // panel width
constexpr int PR = 128;    // panel rows per CTA in trsm_panel
constexpr int TILE = 32;   // syrk output tile edge
constexpr int ROWS = 8;    // syrk thread rows

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

template <typename T>
__global__ void copy_lower(const T* __restrict__ a, T* __restrict__ l, int n,
                           long long total) {
  for (long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(idx % n);
    const int i = (int)((idx / n) % n);
    l[idx] = j <= i ? a[idx] : T(0);
  }
}

template <typename T>
__global__ void __launch_bounds__(NB * NB)
potrf_diag(T* __restrict__ l, int n, int k, int kb) {
  __shared__ T s[NB][NB + 1];
  T* le = l + (size_t)blockIdx.x * n * n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  s[ty][tx] = (ty < kb && tx < kb) ? le[(size_t)(k + ty) * n + k + tx] : T(0);
  __syncthreads();
  for (int j = 0; j < kb; ++j) {
    if (tx == 0 && ty == 0) {
      const T v = s[j][j];
      s[j][j] = v > T(0) ? sqrt_(v) : T(NAN);
    }
    __syncthreads();
    if (tx == 0 && ty > j && ty < kb) s[ty][j] = s[ty][j] / s[j][j];
    __syncthreads();
    if (ty > j && ty < kb && tx > j && tx <= ty) {
      s[ty][tx] -= s[ty][j] * s[tx][j];
    }
    __syncthreads();
  }
  if (ty < kb && tx <= ty) le[(size_t)(k + ty) * n + k + tx] = s[ty][tx];
}

template <typename T>
__global__ void __launch_bounds__(PR)
trsm_panel(T* __restrict__ l, int n, int k, int kb) {
  __shared__ T lkk[NB][NB + 1];
  __shared__ T xs[PR][NB + 1];
  T* le = l + (size_t)blockIdx.y * n * n;
  const int tid = threadIdx.x;
  const int r0 = k + kb + blockIdx.x * PR;
  for (int idx = tid; idx < NB * NB; idx += PR) {
    const int a = idx / NB, b = idx % NB;
    lkk[a][b] = (a < kb && b < kb) ? le[(size_t)(k + a) * n + k + b] : T(0);
  }
  for (int idx = tid; idx < PR * NB; idx += PR) {
    const int rr = idx / NB, c = idx % NB;
    const int r = r0 + rr;
    xs[rr][c] = (r < n && c < kb) ? le[(size_t)r * n + k + c] : T(0);
  }
  __syncthreads();
  if (r0 + tid < n) {
    for (int c = 0; c < kb; ++c) {
      T v = xs[tid][c];
      for (int p = 0; p < c; ++p) v -= xs[tid][p] * lkk[c][p];
      xs[tid][c] = v / lkk[c][c];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < PR * NB; idx += PR) {
    const int rr = idx / NB, c = idx % NB;
    const int r = r0 + rr;
    if (r < n && c < kb) le[(size_t)r * n + k + c] = xs[rr][c];
  }
}

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
syrk_update(T* __restrict__ l, int n, int k, int kb) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;  // tile strictly above the diagonal: nothing to update
  __shared__ T li[TILE][NB + 1];
  __shared__ T lj[TILE][NB + 1];
  T* le = l + (size_t)blockIdx.z * n * n;
  const int t0 = k + kb;
  const int i0 = t0 + bi * TILE, j0 = t0 + bj * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  for (int idx = tid; idx < TILE * NB; idx += TILE * ROWS) {
    const int r = idx / NB, c = idx % NB;
    li[r][c] = (i0 + r < n && c < kb) ? le[(size_t)(i0 + r) * n + k + c] : T(0);
    lj[r][c] = (j0 + r < n && c < kb) ? le[(size_t)(j0 + r) * n + k + c] : T(0);
  }
  __syncthreads();
  const int j = j0 + tx;
  for (int r = ty; r < TILE; r += ROWS) {
    const int i = i0 + r;
    if (i < n && j < n && j <= i) {
      T acc = T(0);
      for (int p = 0; p < kb; ++p) acc += li[r][p] * lj[tx][p];
      le[(size_t)i * n + j] -= acc;
    }
  }
}

template <typename T>
int run(const T* a, T* l, int e, int n, cudaStream_t s) {
  const long long total = (long long)e * n * n;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  copy_lower<T><<<(int)blocks, threads, 0, s>>>(a, l, n, total);
  for (int k = 0; k < n; k += NB) {
    const int kb = n - k < NB ? n - k : NB;
    potrf_diag<T><<<e, dim3(NB, NB), 0, s>>>(l, n, k, kb);
    const int rest = n - k - kb;
    if (rest > 0) {
      trsm_panel<T><<<dim3((rest + PR - 1) / PR, e), PR, 0, s>>>(l, n, k, kb);
      const int tiles = (rest + TILE - 1) / TILE;
      syrk_update<T><<<dim3(tiles, tiles, e), dim3(TILE, ROWS), 0, s>>>(
          l, n, k, kb);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// a (e, n, n) input, l (e, n, n) output (must not alias a).
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int cholesky_blocked(const void* a, void* l, int e, int n,
                                int is_f64, void* stream) {
  if (n < 1 || e < 1 || e > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return run<double>(static_cast<const double*>(a), static_cast<double*>(l),
                       e, n, s);
  }
  return run<float>(static_cast<const float*>(a), static_cast<float*>(l), e, n,
                    s);
}
