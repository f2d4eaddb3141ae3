// The in-shared-memory Cholesky of a block, shared by the blocked Cholesky
// (cholesky.cu: its shared-memory tier and its panels) and the large-matrix
// Cholesky (cholesky_hbm.cu: its diagonal blocks).
//
// Right-looking in 16-wide sub-blocks: one warp factors the 16 x 16
// diagonal sub-block in registers (a row per lane, columns exchanged by
// shuffles, no block barrier), one thread per row solves the rows below it,
// and the trailing triangle takes a rank-16 update in 4 x 4 register tiles
// read from a transposed copy of the panel; three barriers per 16 columns.
// A non-positive (or NaN) pivot gives NaN from that column on. FMA in the
// block's own type (f32 or f64; no TF32).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "gemm_tile.cuh"

namespace {

constexpr int SUB = 16;             // sub-block width of factor_smem
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

// Factors the lower triangle of s (nn x nn, row stride ld, shared memory)
// in place into L (the upper triangle is neither read nor written) and
// writes the reciprocal of L's diagonal into rd (nn); pt is a 16 x ptld
// shared scratch (ptld a multiple of 4, 16-byte aligned). Needs
// blockDim.x >= max(32, nn - 16).
template <typename T>
__device__ void factor_smem(T* s, int ld, int nn, T* pt, int ptld, T* rd) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int c0 = 0; c0 < nn; c0 += SUB) {
    const int kb = min(SUB, nn - c0);
    // 1. warp 0: the diagonal sub-block, a row per lane; lanes past kb carry
    //    an identity row
    if (tid < 32) {
      const int r = tid;
      T row[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        row[j] = (r < kb && j <= r) ? s[(c0 + r) * ld + c0 + j]
                                    : (r == j ? T(1) : T(0));
      }
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        const T v = __shfl_sync(FULL, row[k], k);
        const T d = v > T(0) ? sqrt_(v) : T(NAN);
        const T inv = T(1) / d;
        if (r == k) {
          row[k] = d;
          if (k < kb) rd[c0 + k] = inv;
        } else if (r > k) {
          row[k] *= inv;
        }
#pragma unroll
        for (int j = k + 1; j < SUB; ++j) {
          const T ljk = __shfl_sync(FULL, row[k], j);
          if (r >= j) row[j] -= row[k] * ljk;
        }
      }
      if (r < kb) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          if (j <= r) s[(c0 + r) * ld + c0 + j] = row[j];
        }
      }
    }
    __syncthreads();
    const int t = nn - c0 - kb;  // rows below the sub-block (kb == SUB if t)
    if (t <= 0) break;
    // 2. one thread per row below: L[i, c0:c0+16] = S[i, c0:c0+16] L_sub^-T,
    //    also into the transposed panel copy pt (zero-padded to 4 rows); the
    //    reciprocals keep divisions off the row's chain
    if (tid < t) {
      const int i = c0 + SUB + tid;
      T x[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) x[j] = s[i * ld + c0 + j];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        x[j] *= rd[c0 + j];
#pragma unroll
        for (int q = j + 1; q < SUB; ++q) x[q] -= x[j] * s[(c0 + q) * ld + c0 + j];
      }
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        s[i * ld + c0 + j] = x[j];
        pt[j * ptld + tid] = x[j];
      }
    } else if (tid < (t + 3) / 4 * 4) {
#pragma unroll
      for (int j = 0; j < SUB; ++j) pt[j * ptld + tid] = T(0);
    }
    __syncthreads();
    // 3. rank-16 update of the trailing lower triangle, 4 x 4 tiles (I, J)
    //    with J <= I, enumerated row-major over the tile triangle
    const int nt = (t + 3) / 4;
    const int ntiles = nt * (nt + 1) / 2;
    const int o = c0 + SUB;
    for (int k = tid; k < ntiles; k += nthr) {
      int ti = (int)((sqrtf(8.0f * (float)k + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > k) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= k) ++ti;
      const int tj = k - ti * (ti + 1) / 2;
      T acc[4][4] = {};
#pragma unroll
      for (int p = 0; p < SUB; ++p) {
        T a[4], b[4];
        lds4(a, pt + p * ptld + 4 * ti);
        lds4(b, pt + p * ptld + 4 * tj);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[q][w] += a[q] * b[w];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * ti + q;
        if (i >= t) continue;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = 4 * tj + w;
          if (j <= i) s[(o + i) * ld + o + j] -= acc[q][w];
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace
