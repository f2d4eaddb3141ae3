// Block-level RBF GP posterior at a block of query lanes, shared by
// gp_predict.cu and cem_score.cu.
//
// A block of NT = 128 threads owns LB = 32 query lanes. Thread t serves lane
// t % LB and row group t / LB (G = 4 groups, one warp each): every sum over
// the n support rows is split over the four warps and reduced through shared
// memory at the end, so a block keeps four warps busy on 32 lanes and a
// launch over L lanes has L / 32 blocks to spread over the SMs.
//
// For one output dim, at the lanes' inputs z (d, LB) in shared memory:
//
//   kv_i   = sf2 exp(-0.5 sum_j ((x_ij il_j) - (z_j il_j))^2)    (n, LB)
//   mu     = sum_i w_mean_i kv_i
//   quad   = sum_i kv_i sum_k w_var_ik kv_k
//   s      = sum_i kv_i w_mean_i,  rows_j = sum_i x_ij kv_i w_mean_i
//
// kv stays in shared memory (n * LB values); w_var is streamed through
// shared memory in tiles of R = 16 rows, so n is bounded by the shared
// memory of one block (n <= 1024 in f32, 512 in f64), not by w_var's n^2.
// Every product is an IEEE FMA on the CUDA cores; no tensor cores, no TF32.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gpl {

constexpr int NT = 128;        // threads per block
constexpr int LB = 32;         // query lanes per block
constexpr int G = NT / LB;     // row groups (warps) splitting each sum
constexpr int RT = 4;          // w_var rows per thread per tile
constexpr int R = G * RT;      // w_var rows per shared-memory tile
constexpr int DMAX = 8;        // largest input width
constexpr int NRED = 3 + DMAX; // partials per lane: mu, quad, s, rows[d]
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory of one block

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

// max(a, b) that propagates a NaN in a, as torch.maximum / jnp.maximum do.
template <typename T>
__device__ __forceinline__ T maxnan(T a, T b) { return (a != a || a > b) ? a : b; }

template <typename T>
struct Smem {
  T* xs;   // (n, d) support rows
  T* kv;   // (n, LB) cross-covariances of the current output dim
  T* wt;   // (R, n) one row tile of w_var
  T* red;  // (G - 1, NRED, LB) partial sums of row groups 1..G-1
  T* zb;   // (DMAX, LB) query inputs of the block's lanes
};

inline size_t smem_bytes(int n, int d, size_t elem) {
  return elem * ((size_t)n * d + (size_t)n * LB + (size_t)R * n +
                 (size_t)(G - 1) * NRED * LB + (size_t)DMAX * LB);
}

template <typename T>
__device__ Smem<T> carve(T* base, int n, int d) {
  Smem<T> s;
  s.xs = base;
  s.kv = s.xs + (size_t)n * d;
  s.wt = s.kv + (size_t)n * LB;
  s.red = s.wt + (size_t)R * n;
  s.zb = s.red + (size_t)(G - 1) * NRED * LB;
  return s;
}

template <typename T>
__device__ void load_rows(const Smem<T>& sm, const T* __restrict__ x, int n,
                          int d) {
  for (int idx = threadIdx.x; idx < n * d; idx += NT) sm.xs[idx] = x[idx];
}

// Posterior of one output dim at the block's lanes (inputs in sm.zb). Every
// thread of the block calls it. On return the threads of row group 0 (warp
// 0) hold, for their lane, mu, quad and, when want_jac, s and rows[0..d).
template <typename T>
__device__ void posterior_dim(const Smem<T>& sm, const T* __restrict__ wm,
                              const T* __restrict__ wv,
                              const T* __restrict__ il, T sf2, int n, int d,
                              bool want_jac, T& mu, T& quad, T& s, T* rows) {
  const int tid = threadIdx.x, l = tid % LB, g = tid / LB;
  __syncthreads();  // zb written; the previous call's kv and red consumed
  T z[DMAX], ilr[DMAX];
  for (int j = 0; j < d; ++j) {
    z[j] = sm.zb[j * LB + l];
    ilr[j] = il[j];
  }
  for (int i = g; i < n; i += G) {
    T d2 = T(0);
    for (int j = 0; j < d; ++j) {
      const T df = sm.xs[i * d + j] * ilr[j] - z[j] * ilr[j];
      d2 += df * df;
    }
    sm.kv[i * LB + l] = sf2 * exp_(T(-0.5) * d2);
  }
  __syncthreads();

  T mu_p = T(0), s_p = T(0), q_p = T(0), rows_p[DMAX];
  for (int j = 0; j < DMAX; ++j) rows_p[j] = T(0);
  for (int i = g; i < n; i += G) {
    const T k = sm.kv[i * LB + l], w = wm[i];
    mu_p += w * k;
    if (want_jac) {
      const T wj = k * w;
      s_p += wj;
      for (int j = 0; j < d; ++j) rows_p[j] += sm.xs[i * d + j] * wj;
    }
  }
  // quad: w_var in tiles of R rows; thread (g, l) owns tile rows g + G k
  for (int i0 = 0; i0 < n; i0 += R) {
    const int valid = min(R, n - i0) * n;
    for (int idx = tid; idx < R * n; idx += NT)
      sm.wt[idx] = idx < valid ? wv[(size_t)i0 * n + idx] : T(0);
    __syncthreads();
    T acc[RT];
#pragma unroll
    for (int k = 0; k < RT; ++k) acc[k] = T(0);
    for (int j = 0; j < n; ++j) {
      const T kj = sm.kv[j * LB + l];
#pragma unroll
      for (int k = 0; k < RT; ++k) acc[k] += sm.wt[(g + G * k) * n + j] * kj;
    }
#pragma unroll
    for (int k = 0; k < RT; ++k) {
      const int i = i0 + g + G * k;
      if (i < n) q_p += sm.kv[i * LB + l] * acc[k];
    }
    __syncthreads();  // the tile is consumed before the next is staged
  }

  if (g > 0) {
    T* r = sm.red + (size_t)(g - 1) * NRED * LB;
    r[0 * LB + l] = mu_p;
    r[1 * LB + l] = q_p;
    r[2 * LB + l] = s_p;
    for (int j = 0; j < d; ++j) r[(3 + j) * LB + l] = rows_p[j];
  }
  __syncthreads();
  if (g == 0) {
    for (int h = 0; h < G - 1; ++h) {
      const T* r = sm.red + (size_t)h * NRED * LB;
      mu_p += r[0 * LB + l];
      q_p += r[1 * LB + l];
      s_p += r[2 * LB + l];
      for (int j = 0; j < d; ++j) rows_p[j] += r[(3 + j) * LB + l];
    }
    mu = mu_p;
    quad = q_p;
    s = s_p;
    for (int j = 0; j < d; ++j) rows[j] = rows_p[j];
  }
}

// Raise a kernel's dynamic shared-memory limit to what a launch needs.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace gpl
