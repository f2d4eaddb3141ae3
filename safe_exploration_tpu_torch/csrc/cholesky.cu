// Blocked lower Cholesky factorization, batched over matrices.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/cholesky.py
// (_chol_kernel with upper_chol_rows_ref / upper_tri_inv_rows_ref, reached
// through cholesky_blocked). Same contract: A (e, n, n) SPD -> L (e, n, n)
// lower with L L^T = A and zeros above the diagonal, only the lower triangle
// of A is read, and a non-positive pivot yields NaN (it does not raise) from
// that column on, so the GP refit's downstream finiteness checks catch a
// broken factor.
//
// Two tiers in one entry:
//   shared-memory tier (n <= 224 in f32, 160 in f64; the refit's n = 128):
//     one launch, one CTA per matrix, the whole lower triangle in dynamic
//     shared memory, factored right-looking in 16-wide sub-blocks
//     (factor_smem.cuh): one warp factors the 16 x 16 diagonal sub-block in
//     registers (a row per lane, columns exchanged by shuffles, no block
//     barrier), one thread per row solves the rows below against it, and the
//     trailing triangle takes a rank-16 update in 4 x 4 register tiles read
//     from a transposed copy of the panel; three barriers per 16 columns.
//   blocked tier (larger n; the refit's n = 512): right-looking over 64-wide
//     panels, two launches per panel: chol_panel factors the 64 x 64
//     diagonal block (factor_smem, redundantly in every CTA) and solves one
//     64-row chunk of the strip below per CTA, reading A itself for the first
//     panel (no copy pass); its CTA 0 writes the previous panel's diagonal
//     block with zeros right of it, so that no CTA overwrites a block that
//     another CTA of its launch reads; chol_update subtracts the panel's
//     rank-64 product from the trailing lower triangle in 64 x 64
//     register-tiled products (gemm_tile.cuh).
//
// What bounds it on an H100: neither bytes nor flops. n^3 / 3 flops
// (0.7 MFLOP at n = 128, 45 MFLOP at n = 512) and n (n + 1) / 2 + n^2
// words (the triangle read, the factor written) are microseconds of work;
// the factorization is a chain of n dependent pivots. What the design
// does about it: below 225 (160) columns the chain never
// leaves one SM and pays 3 barriers per 16 pivots instead of 3 launches per
// 32 (11 launches at n = 128 before); above, 2 launches per 64 columns
// instead of 3 per 32 plus a copy (15 at n = 512, 47 before), and the O(n^3)
// update runs at a register-tiled product's rate over every trailing tile.
// FMA on the CUDA cores in the matrices' own type (f32 or f64; no TF32, no
// library call).

#include <cuda_runtime.h>
#include <math.h>

#include "factor_smem.cuh"
#include "gemm_tile.cuh"

namespace {

constexpr int P = TILE;             // panel width of the blocked tier
constexpr int LDP = P + 1;          // padded row stride of the diagonal block
constexpr int SMEM_THREADS = 512;

// Most columns the shared-memory tier holds: the triangle (n x (n + 1) or
// n x (n + 2)) and the 16 x n panel copy in the SM's 227 KB.
template <typename T>
constexpr int smem_max_n() { return sizeof(T) == 8 ? 160 : 224; }

__host__ __device__ inline int odd_ld(int n) { return n + 1 + (n & 1); }
__host__ __device__ inline int pt_ld(int n) { return (n + 3) / 4 * 4; }

// The shared-memory tier: one CTA factors one matrix.
template <typename T>
__global__ void __launch_bounds__(SMEM_THREADS)
chol_smem(const T* __restrict__ a_all, T* __restrict__ l_all, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ld = odd_ld(n);
  T* pt = s + ((size_t)n * ld + 3) / 4 * 4;  // 16-byte aligned
  T* rd = pt + SUB * pt_ld(n);
  const T* a = a_all + (size_t)blockIdx.x * n * n;
  T* l = l_all + (size_t)blockIdx.x * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += SMEM_THREADS) {
    const int i = idx / n, j = idx % n;
    if (j <= i) s[i * ld + j] = a[idx];
  }
  __syncthreads();
  factor_smem<T>(s, ld, n, pt, pt_ld(n), rd);
  for (int idx = threadIdx.x; idx < n * n; idx += SMEM_THREADS) {
    const int i = idx / n, j = idx % n;
    l[idx] = j <= i ? s[i * ld + j] : T(0);
  }
}

__host__ inline size_t smem_tier_bytes(int n, size_t sz) {
  return (((size_t)n * odd_ld(n) + 3) / 4 * 4 + (size_t)SUB * pt_ld(n) + n) *
         sz;
}

// The blocked tier's panel at column k0. CTA x >= 1 factors the 64 x 64
// diagonal block itself and solves the strip rows [k0 + 64 x, + 64)
// against it (in the last panel, which has no strip, CTA 1 writes the
// factored block instead). CTA 0 writes the block of the panel before,
// factored again, with zeros right of it: that block still stands
// unfactored where the launch before read it, and no CTA of this launch
// reads it, so no CTA writes what another CTA of its launch reads (CTAs of
// one grid run in no fixed order). A block stands in A for the first panel
// and in L (updated in place) after.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
chol_panel(const T* a_all, T* l_all, int n, int k0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T (*s)[LDP] = reinterpret_cast<T (*)[LDP]>(smem_raw);
  T (*xs)[LDP] = s + P;
  T* pt = reinterpret_cast<T*>(xs + P);  // SUB x P, 16-byte aligned
  T* rd = pt + SUB * P;                  // P reciprocals of the diagonal
  const int d0 = blockIdx.x == 0 ? k0 - P : k0;  // the block this CTA factors
  if (d0 < 0) return;
  const bool strip = blockIdx.x > 0 && k0 + P < n;
  const T* src = (d0 == 0 ? a_all : l_all) + (size_t)blockIdx.y * n * n;
  T* l = l_all + (size_t)blockIdx.y * n * n;
  const int tid = threadIdx.x;
  const int kb = min(P, n - d0);
  const int r0 = k0 + P * blockIdx.x;  // this CTA's strip rows
  for (int idx = tid; idx < P * P; idx += TILE_THREADS) {
    const int i = idx / P, j = idx % P;
    if (i < kb && j <= i) s[i][j] = src[(size_t)(d0 + i) * n + d0 + j];
    if (strip && r0 + i < n) {
      xs[i][j] = src[(size_t)(r0 + i) * n + k0 + j];  // kb == P here
    }
  }
  __syncthreads();
  factor_smem<T>(&s[0][0], LDP, kb, pt, P, rd);
  if (!strip) {
    for (int idx = tid; idx < P * P; idx += TILE_THREADS) {
      const int i = idx / P, j = idx % P;
      if (i < kb && j < kb) {
        l[(size_t)(d0 + i) * n + d0 + j] = j <= i ? s[i][j] : T(0);
      }
    }
    const int right = n - d0 - kb;
    for (int idx = tid; idx < kb * right; idx += TILE_THREADS) {
      l[(size_t)(d0 + idx / right) * n + d0 + kb + idx % right] = T(0);
    }
    return;
  }
  // one row per thread of the first two warps: x = S_i L_kk^-T, column by
  // column so that each step's updates are independent
  if (tid < P && r0 + tid < n) {
    T x[P];
#pragma unroll
    for (int c = 0; c < P; ++c) x[c] = xs[tid][c];
#pragma unroll
    for (int c = 0; c < P; ++c) {
      x[c] *= rd[c];
#pragma unroll
      for (int q = c + 1; q < P; ++q) x[q] -= x[c] * s[q][c];
    }
#pragma unroll
    for (int c = 0; c < P; ++c) xs[tid][c] = x[c];
  }
  __syncthreads();
  for (int idx = tid; idx < P * P; idx += TILE_THREADS) {
    const int i = idx / P, j = idx % P;
    if (r0 + i < n) l[(size_t)(r0 + i) * n + k0 + j] = xs[i][j];
  }
}

// The trailing update after the panel at k0: for each 64 x 64 tile of the
// lower triangle of [k0 + 64, n)^2, L_ij = S_ij - L_i,panel L_j,panel^T
// (elements above the diagonal untouched). src is A for the first panel
// and L after; an
// element is read and written by the same thread, so src may be l.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
chol_update(const T* src_all, T* l_all, int n, int k0) {
  __shared__ TileSmem<T> sm;
  const int t0 = k0 + P;
  const int tiles = (n - t0 + TILE - 1) / TILE;
  const int bi = blockIdx.x / tiles, bj = blockIdx.x % tiles;
  if (bj > bi) return;
  const T* src = src_all + (size_t)blockIdx.y * n * n;
  T* l = l_all + (size_t)blockIdx.y * n * n;
  const int i0 = t0 + TILE * bi, j0 = t0 + TILE * bj;
  T acc[4][4] = {};
  gemm_tile<T, false, true>(acc, sm, l + (size_t)i0 * n + k0, n, n - i0,
                            l + (size_t)j0 * n + k0, n, n - j0, 0, P);
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

// Dynamic shared memory above the default 48 KB needs the kernel's
// attribute raised first (a host call, so only then).
cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
int run(const T* a, T* l, int e, int n, cudaStream_t s) {
  if (n <= smem_max_n<T>()) {
    const size_t bytes = smem_tier_bytes(n, sizeof(T));
    const cudaError_t err = set_smem((const void*)chol_smem<T>, bytes);
    if (err != cudaSuccess) return (int)err;
    chol_smem<T><<<e, SMEM_THREADS, bytes, s>>>(a, l, n);
    return (int)cudaGetLastError();
  }
  const size_t pbytes = (2 * P * LDP + SUB * P + P) * sizeof(T);
  const cudaError_t err = set_smem((const void*)chol_panel<T>, pbytes);
  if (err != cudaSuccess) return (int)err;
  for (int k0 = 0; k0 < n; k0 += P) {
    const int kb = n - k0 < P ? n - k0 : P;
    const int strips = (n - k0 - kb + P - 1) / P;
    chol_panel<T><<<dim3(1 + (strips > 0 ? strips : 1), e), TILE_THREADS,
                     pbytes, s>>>(a, l, n, k0);
    if (strips > 0) {
      chol_update<T><<<dim3(strips * strips, e), TILE_THREADS, 0, s>>>(
          k0 == 0 ? a : l, l, n, k0);
    }
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
  }
  return 0;
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
