// Block-level RBF GP posterior at a block of query lanes: the one posterior
// implementation of gp_predict.cu and cem_score.cu.
//
// A block of NT threads owns LB query lanes (LB = 32 or 64). For one output
// dim, with the lanes' inputs z in registers:
//
//   kv_stage   kv_i = sf2 exp(-0.5 sum_j (x_ij il_j - z_j il_j)^2)  (n, LB)
//              in shared memory; thread (l = tid % LB, g = tid / LB) takes
//              rows g, g + G, ... (G = NT / LB threads per lane)
//   mean_rows  the mean sum_i w_i kv_i and, for the Jacobian, the rows
//              sum_i x_ij (kv_i w_i), one (row, lane) per thread
//   quad_form  quad = kv^T W kv: V = W KV in RT x LB tiles (RT = 16 NT /
//              LB rows), 4 rows x 4 lanes per thread from two vector
//              shared-memory loads per 16 FMA, reduced against KV, summed
//              over a warp's row groups by shuffles and over the warps
//              through shared memory
//
// W is read transposed (W^T, so a row of the product tile is contiguous),
// resident in shared memory (rows padded to pad4(n), loaded by load_w_async
// with cp.async so the copy overlaps the first kv_stage) or streamed from
// global memory in KS-deep slices. Every product is an IEEE FMA on the CUDA
// cores; no tensor cores, no TF32.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"

namespace gpl {

constexpr int DMAX = 8;               // largest input width
constexpr int KS = 16;                // depth slice of a streamed W
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory of one block
constexpr unsigned ALL = 0xffffffffu;

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

// max(a, b) that propagates a NaN in a, as torch.maximum / jnp.maximum do.
template <typename T>
__device__ __forceinline__ T maxnan(T a, T b) { return (a != a || a > b) ? a : b; }

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// rows of a product tile: 4 per thread row group
template <int NT, int LB>
__host__ __device__ constexpr int rows_per_tile() { return 4 * (NT / (LB / 4)); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "n"(B));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts asynchronous copies of `dims` consecutive n x n matrices W^T into
// shared memory rows of pad4(n) (the pad columns zeroed): 16 bytes a copy
// where n is a multiple of 4 (rows contiguous), else one element a copy.
// The caller ends them with cp_async_wait_all() and a block barrier.
template <typename T, int NT>
__device__ __forceinline__ void load_w_async(T* wsh, const T* wvt, int n,
                                             int dims) {
  const int np = pad4(n);
  if (np == n) {
    const int n16 = dims * n * n * (int)sizeof(T) / 16;
    const char* src = reinterpret_cast<const char*>(wvt);
    char* dst = reinterpret_cast<char*>(wsh);
    for (int idx = threadIdx.x; idx < n16; idx += NT)
      cp_async16(dst + 16 * (size_t)idx, src + 16 * (size_t)idx);
  } else {
    for (int idx = threadIdx.x; idx < dims * n * np; idx += NT) {
      const int ek = idx / np, r = idx % np;
      if (r < n) {
        cp_async<sizeof(T)>(wsh + idx, wvt + (size_t)ek * n + r);
      } else {
        wsh[idx] = T(0);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// kv[i LB + l] = sf2 exp(-0.5 |xe_i - z il|^2) of the block's lanes for one
// output dim: xe (n x d) the dim's support rows over its lengthscales (in
// shared memory), il its inverse lengthscales.
template <typename T, int NT, int LB>
__device__ __forceinline__ void kv_stage(T* kv, const T* xe, const T (&z)[DMAX],
                                         const T* il, T sf2, int n, int d) {
  constexpr int G = NT / LB;
  const int l = threadIdx.x % LB, g = threadIdx.x / LB;
  T zil[DMAX];
#pragma unroll
  for (int j = 0; j < DMAX; ++j) zil[j] = j < d ? z[j] * il[j] : T(0);
  for (int i = g; i < n; i += G) {
    T d2 = T(0);
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      if (j >= d) break;
      const T df = xe[i * d + j] - zil[j];
      d2 += df * df;
    }
    kv[i * LB + l] = sf2 * exp_(T(-0.5) * d2);
  }
}

// aug[r LB + l] for r < rows: r = 0 the mean sum_i w_i kv_i, r = 1 + j the
// Jacobian's row sum_i x_ij (kv_i w_i) (xs the support rows, n x d); one
// (row, lane) per thread.
template <typename T, int NT, int LB>
__device__ __forceinline__ void mean_rows(T* aug, const T* kv, const T* xs,
                                          const T* w, int n, int d, int rows) {
  constexpr int G = NT / LB;
  const int l = threadIdx.x % LB, g = threadIdx.x / LB;
  for (int r = g; r < rows; r += G) {
    T acc = T(0);
    if (r == 0) {
      for (int i = 0; i < n; ++i) acc += w[i] * kv[i * LB + l];
    } else {
      for (int i = 0; i < n; ++i) acc += xs[i * d + r - 1] * (kv[i * LB + l] * w[i]);
    }
    aug[r * LB + l] = acc;
  }
}

// quad = kv^T W kv for the thread's lane, returned to every thread of the
// block (all of them call it). W^T is read from wsh, resident in shared
// memory (rows of pad4(n)), or, when !resident, from wg in global memory
// (rows of n), streamed in KS-deep slices through wslice (KS x RT); two
// pointers, so the resident product's loads stay shared-memory loads.
// red holds NT / 32 x LB partial sums. Ends after a block barrier, so what
// the threads wrote before the call (the mean rows) is visible on return.
template <typename T, int NT, int LB>
__device__ __forceinline__ T quad_form(const T* kv, const T* wsh, const T* wg,
                                       bool resident, T* wslice, T* red,
                                       int n) {
  constexpr int TX = LB / 4;       // lane groups of 4 in the product tile
  constexpr int RT = rows_per_tile<NT, LB>();
  const int tid = threadIdx.x, l = tid % LB;
  const int tx = tid % TX, ty = tid / TX;   // place in the product tile
  const int np = pad4(n);
  T qp[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) qp[c] = T(0);
  for (int r0 = 0; r0 < np; r0 += RT) {
    const int rr = r0 + 4 * ty;   // this thread's first row
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = T(0);
    auto step = [&](const T* wrow, const T* kvrow) {
      T wv[4], kr[4];
      lds4(wv, wrow);
      lds4(kr, kvrow + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += wv[i] * kr[c];
      }
    };
    if (resident) {
      if (rr < np) {
        const T* w0 = wsh + rr;
        for (int k = 0; k < n; ++k) step(w0 + (size_t)k * np, kv + k * LB);
      }
    } else {
      for (int k0 = 0; k0 < n; k0 += KS) {
        for (int idx = tid; idx < KS * RT; idx += NT) {
          const int kk = idx / RT, r = r0 + idx % RT;
          wslice[idx] = (k0 + kk < n && r < n)
                            ? wg[(size_t)(k0 + kk) * n + r] : T(0);
        }
        __syncthreads();
        const int kn = min(KS, n - k0);
        if (rr < np) {
          for (int kk = 0; kk < kn; ++kk) {
            step(wslice + kk * RT + 4 * ty, kv + (k0 + kk) * LB);
          }
        }
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (rr + i >= n) break;
      T kr[4];
      lds4(kr, kv + (rr + i) * LB + 4 * tx);
#pragma unroll
      for (int c = 0; c < 4; ++c) qp[c] += kr[c] * acc[i][c];
    }
  }
  // the row groups of a warp share their lanes: sum them by shuffles, one
  // partial per warp and lane to shared memory
#pragma unroll
  for (int off = TX; off < 32; off *= 2) {
#pragma unroll
    for (int c = 0; c < 4; ++c) qp[c] += __shfl_xor_sync(ALL, qp[c], off);
  }
  if (tid % 32 < TX) {
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(tid / 32) * LB + 4 * tx + c] = qp[c];
  }
  __syncthreads();
  T quad = T(0);
  for (int h = 0; h < NT / 32; ++h) quad += red[h * LB + l];
  return quad;
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
