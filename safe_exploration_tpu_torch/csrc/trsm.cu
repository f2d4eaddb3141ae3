// Triangular solves and the triangular inverse, batched over matrices.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/trsm.py
// (_trsm_kernel, reached through trsm_lower_blocked and solve_psd_blocked):
// X = L^-1 B (forward) or X = L^-T B (transposed) for lower L (e, n, n) and
// B (e, n, m); only the lower triangle of L is read. As in the Pallas kernel,
// the 64 x 64 diagonal blocks of L are inverted first (they depend on L
// alone, so that is parallel over every block), and each step of a solve
// becomes a product with inv(L_ii) instead of a row-by-row substitution.
// Three entries, one per call shape of the GP refit:
//
//   trsm_lower     general m: one CTA per 64 right-hand-side columns walks
//                  the 64-row blocks; each step is two register-tiled
//                  products (the solved prefix, then inv(L_ii)); m = 1 takes
//                  the vector kernel below.
//   trsm_solve_psd (L L^T) x = b for m = 1 (the refit's beta) in one launch
//                  after the diagonal inverses: the forward solve, then the
//                  transposed one, in one thread-block cluster per matrix.
//   tri_inv_lower  X = L^-1 (the refit's K^-1 = L^-T L^-1) by recursive
//                  doubling: with inv(A), inv(C) of two neighbouring s-blocks
//                  known, the block below them is -inv(C) (B inv(A)), two
//                  register-tiled products per level, s = 64 .. n/2. Only the
//                  triangles are multiplied (n^3 / 3 flops, not the n^3 / 2
//                  of a solve against the identity), and every level spreads
//                  over all tiles of all pairs of all matrices.
//
// What bounds them on an H100: K^-1's inverse is n^3 / 3 flops per matrix
// (5.7 GFLOP for e = 2 at n = 2048: 0.085 ms at the f32 peak), bound by
// operations; beta is two triangular matrix-vector chains, bound by bytes
// (L's lower triangle, 8.4 MB per matrix in f32 at n = 2048, read once from
// HBM: 2.5 us at 3.35 TB/s; the second direction's read can hit the 50 MB
// L2) and, in practice, by its chain of n / 64 dependent steps per
// direction. What the designs do
// about it: the inverse has no chain longer than log2(n / 64) levels; the
// vector solve keeps the chain on chip — the cluster's CTAs (up to 16 SMs
// per matrix) own interleaved row blocks, the block that finishes next is
// updated first and its L tile and inv(L_ii) are prefetched (cp.async)
// while the others stream their updates with 16-byte loads, each finished
// block is stored into every CTA's shared memory (distributed shared
// memory) and the step ends in a split cluster barrier (arrive, then wait),
// not a launch. FMA on
// the CUDA cores in the matrices' own type (f32 or f64; no TF32, no library
// call).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gemm_tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NB = TILE;      // diagonal block, row block and GEMM tile edge
                              // (BLOCK in ops/kernels/trsm.py)
constexpr int THREADS = TILE_THREADS;
constexpr int LDB = NB + 1;   // padded stride of square blocks in shared memory
constexpr int INV_THREADS = 128;
constexpr int VEC_MAX_N = 4096;  // the vector kernel's shared memory limit
constexpr int PARTS = 16;        // partial sums per output of the vector solve
constexpr int PSTRIDE = PARTS + 1;  // their padded stride in shared memory

// Inverts the 64 x 64 lower diagonal blocks of L (a ragged last block is
// padded with the identity). Block k of matrix m goes to
// dst + m * dst_mat + k * dst_blk with row stride dst_ld: the whole padded
// block with full_out, else its valid part (upper triangle zero).
// Warps 0 and 1 invert the two 32 x 32 diagonal sub-blocks by substitution,
// a column per lane in registers (no barrier; the diagonal's reciprocals
// are taken first, so no division is on the chain); then the block below
// them is -inv(C) (B inv(A)), 8 outputs per thread.
template <typename T>
__global__ void __launch_bounds__(INV_THREADS)
inv_diag(const T* __restrict__ l_all, T* __restrict__ dst_all, int n,
         long long dst_mat, long long dst_blk, int dst_ld, int full_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T (*ls)[LDB] = reinterpret_cast<T (*)[LDB]>(smem_raw);
  T (*xs)[LDB] = ls + NB;
  T* rd = &xs[NB][0];  // NB reciprocals of the diagonal
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * NB;
  const int bs = min(NB, n - b0);
  const T* l = l_all + (size_t)blockIdx.y * n * n;
  T* dst = dst_all + blockIdx.y * dst_mat + blockIdx.x * dst_blk;
  for (int idx = tid; idx < NB * NB; idx += INV_THREADS) {
    const int i = idx / NB, j = idx % NB;
    T v = i == j ? T(1) : T(0);
    if (i < bs && j < bs) v = j <= i ? l[(size_t)(b0 + i) * n + b0 + j] : T(0);
    ls[i][j] = v;
  }
  __syncthreads();
  // the diagonal's reciprocals, off the substitution's dependent chain
  if (tid < NB) rd[tid] = T(1) / ls[tid][tid];
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  if (warp < 2) {
    const int o = 32 * warp;
    T x[32];
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      T s0 = r == lane ? T(1) : T(0), s1 = T(0);
#pragma unroll
      for (int k = 0; k + 1 < r; k += 2) {
        s0 -= ls[o + r][o + k] * x[k];
        s1 -= ls[o + r][o + k + 1] * x[k + 1];
      }
      if (r & 1) s0 -= ls[o + r][o + r - 1] * x[r - 1];
      x[r] = r < lane ? T(0) : (s0 + s1) * rd[o + r];
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) xs[o + r][o + lane] = x[r];
  }
  __syncthreads();
  // B inv(A) into the free upper-right quarter of ls, then -inv(C) of it:
  // thread (row i, columns jq + 4 w); the inverses are zero above their
  // diagonals, so the sums run over all 32 terms
  const int i = tid / 4, jq = tid % 4;
  T acc[8] = {};
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const T b = ls[32 + i][k];
#pragma unroll
    for (int w = 0; w < 8; ++w) acc[w] += b * xs[k][jq + 4 * w];
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) ls[i][32 + jq + 4 * w] = acc[w];
  __syncthreads();
#pragma unroll
  for (int w = 0; w < 8; ++w) acc[w] = T(0);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const T c = xs[32 + i][32 + k];
#pragma unroll
    for (int w = 0; w < 8; ++w) acc[w] += c * ls[k][32 + jq + 4 * w];
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    xs[32 + i][jq + 4 * w] = -acc[w];
    xs[i][32 + jq + 4 * w] = T(0);
  }
  __syncthreads();
  const int lim = full_out ? NB : bs;
  for (int idx = tid; idx < NB * NB; idx += INV_THREADS) {
    const int i = idx / NB, j = idx % NB;
    if (i < lim && j < lim) dst[(size_t)i * dst_ld + j] = xs[i][j];
  }
}

// One level of the recursive inverse, first product: for the pair of
// s-blocks A = [r0, r0 + s), C = [r0 + s, r0 + s + sc) (r0 = 2 s pair),
// W[C rows, 0:s) = L[C rows, A cols] inv(A), and zeros into X's mirrored
// upper block X[A rows, C cols]. One 64 x 64 tile per CTA.
template <typename T>
__global__ void __launch_bounds__(THREADS)
level_t(const T* __restrict__ l_all, T* __restrict__ x_all,
        T* __restrict__ w_all, int n, int s) {
  __shared__ TileSmem<T> sm;
  const int tiles = s / NB;
  const int ti = blockIdx.x / tiles, tj = blockIdx.x % tiles;
  const int r0 = 2 * s * blockIdx.y;
  const int sc = min(s, n - r0 - s);
  if (NB * ti >= sc) return;
  const size_t off = (size_t)blockIdx.z * n * n;
  const T* l = l_all + off;
  T* x = x_all + off;
  T* w = w_all + off;
  const int i0 = r0 + s + NB * ti, j0 = r0 + NB * tj;
  const int rows = min(NB, sc - NB * ti);
  T acc[4][4] = {};
  // inv(A) is lower: only its rows from the tile's first column on
  gemm_tile<T, false, false>(acc, sm, l + (size_t)i0 * n + r0, n, rows,
                      x + (size_t)r0 * n + j0, n, NB, NB * tj, s);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 4 * ty + q;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      w[(size_t)(i0 + r) * n + NB * tj + 4 * tx + c] = acc[q][c];
    }
  }
  for (int idx = threadIdx.x; idx < NB * NB; idx += THREADS) {
    const int jj = idx / NB, ii = idx % NB;
    if (ii < rows) x[(size_t)(j0 + jj) * n + i0 + ii] = T(0);
  }
}

// Second product of a level: X[C rows, A cols] = -inv(C) W[C rows, 0:s).
template <typename T>
__global__ void __launch_bounds__(THREADS)
level_x(const T* __restrict__ w_all, T* __restrict__ x_all, int n, int s) {
  __shared__ TileSmem<T> sm;
  const int tiles = s / NB;
  const int ti = blockIdx.x / tiles, tj = blockIdx.x % tiles;
  const int r0 = 2 * s * blockIdx.y;
  const int sc = min(s, n - r0 - s);
  if (NB * ti >= sc) return;
  const size_t off = (size_t)blockIdx.z * n * n;
  const T* w = w_all + off;
  T* x = x_all + off;
  const int i0 = r0 + s + NB * ti, j0 = r0 + NB * tj;
  const int rows = min(NB, sc - NB * ti);
  T acc[4][4] = {};
  // inv(C) is lower: only its columns up to the tile's last row
  gemm_tile<T, false, false>(acc, sm, x + (size_t)i0 * n + r0 + s, n, rows,
                      w + (size_t)(r0 + s) * n + NB * tj, n, NB, 0,
                      NB * ti + rows);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = 4 * ty + q;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      x[(size_t)(i0 + r) * n + j0 + 4 * tx + c] = -acc[q][c];
    }
  }
}

// General right-hand sides: CTA (strip, matrix) owns columns
// [64 strip, 64 strip + 64) and walks the row blocks in solve order; a step
// is R = B_i - L_i,solved X_solved, then X_i = inv(L_ii) R (inv(L_ii)^T with
// transpose). R is parked in X's rows, which the step then overwrites; b may
// alias x.
template <typename T>
__global__ void __launch_bounds__(THREADS)
trsm_strips(const T* __restrict__ l_all, const T* __restrict__ d_all,
            const T* b_all, T* x_all, int n, int m, int transpose) {
  __shared__ TileSmem<T> sm;
  const int nb = (n + NB - 1) / NB;
  const int c0 = blockIdx.x * NB;
  const int mc = min(NB, m - c0);
  const T* l = l_all + (size_t)blockIdx.y * n * n;
  const T* d = d_all + (size_t)blockIdx.y * nb * NB * NB;
  const T* b = b_all + (size_t)blockIdx.y * n * m;
  T* x = x_all + (size_t)blockIdx.y * n * m;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int step = 0; step < nb; ++step) {
    const int blk = transpose ? nb - 1 - step : step;
    const int i0 = blk * NB;
    const int bs = min(NB, n - i0);
    T acc[4][4] = {};
    if (transpose) {
      gemm_tile<T, true, false>(acc, sm, l + i0, n, bs, x + c0, m, mc, i0 + bs, n);
    } else {
      gemm_tile<T, false, false>(acc, sm, l + (size_t)i0 * n, n, bs, x + c0, m, mc,
                          0, i0);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * ty + q;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cc = 4 * tx + c;
        if (r < bs && cc < mc) {
          const size_t at = (size_t)(i0 + r) * m + c0 + cc;
          x[at] = b[at] - acc[q][c];
        }
      }
    }
    __syncthreads();
    T y[4][4] = {};
    const T* di = d + (size_t)blk * NB * NB;
    if (transpose) {
      gemm_tile<T, true, false>(y, sm, di, NB, bs, x + (size_t)i0 * m + c0, m, mc, 0,
                         bs);
    } else {
      gemm_tile<T, false, false>(y, sm, di, NB, bs, x + (size_t)i0 * m + c0, m, mc,
                          0, bs);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 4 * ty + q;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cc = 4 * tx + c;
        if (r < bs && cc < mc) x[(size_t)(i0 + r) * m + c0 + cc] = y[q][c];
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// v = p[0 .. 3], as one 16-byte load (two for f64) when vec
template <typename T>
__device__ __forceinline__ void load4(T (&v)[4], const T* p, bool vec) {
  if (vec) {
    if constexpr (sizeof(T) == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
    } else {
      const double2 a = *reinterpret_cast<const double2*>(p);
      const double2 b = *reinterpret_cast<const double2*>(p + 2);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) v[w] = p[w];
  }
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of the vector solve, in elements of T.
__host__ __device__ inline size_t vec_smem_elems(int n, int g) {
  const int nb = (n + NB - 1) / NB;
  const int own = (nb + g - 1) / g;
  return (size_t)nb * NB + (size_t)own * NB * (1 + PSTRIDE) + 2 * NB * LDB +
         5 * NB;
}

// x with L x = b (mode 1), L^T x = b (mode 2) or L L^T x = b (mode 3), for
// one right-hand side; one cluster of G CTAs per matrix. Row block k is
// owned by CTA k % G, which keeps its base values (rs) and 16 partial sums
// per row (part, so the streamed updates need no reduction) in shared
// memory. A step: wait for block `cur` in every CTA's copy of x; the owner
// of the next block adds the last tile, applies its prefetched inverse and
// stores the result into every CTA's x; arrive; the owner of the block
// after that prefetches its tile and inverse; everyone streams the
// contribution of `cur` into the partial sums of the blocks it owns.
template <typename T>
__global__ void __launch_bounds__(THREADS)
solve_vec(const T* __restrict__ l_all, const T* __restrict__ d_all,
          const T* __restrict__ b_all, T* __restrict__ out_all, int n,
          int mode) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nb = (n + NB - 1) / NB;
  const int own = (nb + G - 1) / G;
  const T* l = l_all + (size_t)blockIdx.y * n * n;
  const T* d = d_all + (size_t)blockIdx.y * nb * NB * NB;
  const T* b = b_all + (size_t)blockIdx.y * n;
  T* out = out_all + (size_t)blockIdx.y * n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);          // nb * NB: the solution
  T* rs = xs + nb * NB;                            // own * NB: base values
  T* part = rs + own * NB;                         // own * NB * PSTRIDE
  T (*tile)[LDB] = reinterpret_cast<T (*)[LDB]>(part + own * NB * PSTRIDE);
  T (*dinv)[LDB] = tile + NB;
  T (*red)[NB] = reinterpret_cast<T (*)[NB]>(dinv + NB);  // 4 x NB
  T* rv = red[4];                                          // NB
  const int tid = threadIdx.x;

  cluster.sync();  // every CTA runs before the first remote store

  for (int dir = 0; dir < 2; ++dir) {
    if (!(mode & (1 << dir))) continue;
    const bool tr = dir == 1;
    const bool final_dir = tr || !(mode & 2);
    auto seq = [&](int s) { return tr ? nb - 1 - s : s; };
    auto owner = [&](int blk) { return blk % G; };

    __syncthreads();
    for (int idx = tid; idx < own * NB; idx += THREADS) {
      const int blk = (idx / NB) * G + rank;
      const int row = blk * NB + idx % NB;
      T v = T(0);
      if (blk < nb && row < n) v = (tr && (mode & 1)) ? xs[row] : b[row];
      rs[idx] = v;
    }
    for (int idx = tid; idx < own * NB * PSTRIDE; idx += THREADS) {
      part[idx] = T(0);
    }
    __syncthreads();

    // L tile (blk, cur) for the forward solve, (cur, blk) for the
    // transposed one, and inv(L_blk,blk), into shared memory
    auto prefetch = [&](int blk, int cur) {
      const int r0 = (tr ? cur : blk) * NB, k0 = (tr ? blk : cur) * NB;
      const T* di = d + (size_t)blk * NB * NB;
      for (int idx = tid; idx < NB * NB; idx += THREADS) {
        const int i = idx / NB, j = idx % NB;
        if (cur >= 0 && r0 + i < n && k0 + j < n) {
          cp_async(&tile[i][j], l + (size_t)(r0 + i) * n + k0 + j);
        } else {
          tile[i][j] = T(0);
        }
        cp_async(&dinv[i][j], di + idx);
      }
    };

    // finishes block blk: base - partials - tile x_cur, times the inverse;
    // stores it into every CTA's x and, in the last direction, the output
    auto finish = [&](int blk, int cur) {
      const int slot = blk / G;
      T* pb = part + (size_t)slot * NB * PSTRIDE;
      if (!tr) {
        const int o = tid / 4, q = tid % 4;
        T v = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) v += pb[o * PSTRIDE + 4 * q + k];
        if (cur >= 0) {
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            v += tile[o][16 * q + t] * xs[cur * NB + 16 * q + t];
          }
        }
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) rv[o] = rs[slot * NB + o] - v;
        __syncthreads();
        T y = T(0);
#pragma unroll
        for (int t = 0; t < 16; ++t) y += dinv[o][16 * q + t] * rv[16 * q + t];
        y += __shfl_xor_sync(0xffffffffu, y, 1);
        y += __shfl_xor_sync(0xffffffffu, y, 2);
        if (q == 0) {
          for (int g = 0; g < G; ++g) {
            cluster.map_shared_rank(xs, g)[blk * NB + o] = y;
          }
          const int row = blk * NB + o;
          if (final_dir && row < n) out[row] = y;
        }
      } else {
        const int c = tid % NB, g4 = tid / NB;
        T v = T(0);
#pragma unroll
        for (int k = 0; k < 4; ++k) v += pb[c * PSTRIDE + 4 * g4 + k];
        if (cur >= 0) {
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            v += tile[16 * g4 + t][c] * xs[cur * NB + 16 * g4 + t];
          }
        }
        red[g4][c] = v;
        __syncthreads();
        if (g4 == 0) {
          rv[c] = rs[slot * NB + c] -
                  ((red[0][c] + red[1][c]) + (red[2][c] + red[3][c]));
        }
        __syncthreads();
        T y = T(0);
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          y += dinv[16 * g4 + t][c] * rv[16 * g4 + t];
        }
        red[g4][c] = y;
        __syncthreads();
        if (g4 == 0) {
          y = (red[0][c] + red[1][c]) + (red[2][c] + red[3][c]);
          for (int g = 0; g < G; ++g) {
            cluster.map_shared_rank(xs, g)[blk * NB + c] = y;
          }
          const int row = blk * NB + c;
          if (final_dir && row < n) out[row] = y;
        }
      }
    };

    // the contribution of the finished block cur to the partial sums of
    // every owned block at least two steps after it; a thread reads 4
    // consecutive elements of a row (one vector load when rows are 16-byte
    // aligned), 16 threads a 64-wide row
    const bool vec = (n * sizeof(T)) % 16 == 0;
    auto stream = [&](int cur) {
      const T* xc = xs + cur * NB;
      const int k = tid % PARTS;  // columns 4 k .. 4 k + 3 of the tile
      for (int slot = 0; slot < own; ++slot) {
        const int blk = slot * G + rank;
        if (blk >= nb || (tr ? blk > cur - 2 : blk < cur + 2)) continue;
        T* pb = part + (size_t)slot * NB * PSTRIDE;
        if (!tr) {
          // rows of blk (maybe ragged), columns of cur (a full block)
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int o = tid / PARTS + 16 * p;
            const int row = blk * NB + o;
            if (row >= n) continue;
            T v[4];
            load4(v, l + (size_t)row * n + cur * NB + 4 * k, vec);
            pb[o * PSTRIDE + k] += (v[0] * xc[4 * k] + v[1] * xc[4 * k + 1]) +
                                   (v[2] * xc[4 * k + 2] + v[3] * xc[4 * k + 3]);
          }
        } else {
          // rows 4 rg .. 4 rg + 3 of cur (maybe ragged), columns of blk
          const int rg = tid / PARTS;
          T sum[4] = {};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int row = cur * NB + 4 * rg + t;
            if (row >= n) continue;
            T v[4];
            load4(v, l + (size_t)row * n + blk * NB + 4 * k, vec);
            const T xr = xc[4 * rg + t];
#pragma unroll
            for (int w = 0; w < 4; ++w) sum[w] += v[w] * xr;
          }
#pragma unroll
          for (int w = 0; w < 4; ++w) pb[(4 * k + w) * PSTRIDE + rg] += sum[w];
        }
      }
    };

    if (owner(seq(0)) == rank) {
      prefetch(seq(0), -1);
      cp_async_wait_all();
      __syncthreads();
      finish(seq(0), -1);
    }
    __syncthreads();
    cluster_arrive();
    if (nb > 1 && owner(seq(1)) == rank) prefetch(seq(1), seq(0));
    for (int s = 0; s + 1 < nb; ++s) {
      cluster_wait();
      const int cur = seq(s), nxt = seq(s + 1);
      if (owner(nxt) == rank) {
        cp_async_wait_all();
        __syncthreads();
        finish(nxt, cur);
      }
      __syncthreads();
      cluster_arrive();
      if (s + 2 < nb && owner(seq(s + 2)) == rank) prefetch(seq(s + 2), nxt);
      stream(cur);
    }
    cluster_wait();
  }
}

// CTAs per cluster of the vector solve: its streamed updates are bound by
// how many loads the cluster's SMs keep in flight, so above 256 rows the
// cluster takes 8 CTAs and above 512 the non-portable 16.
int grid_g(int n) { return n <= 256 ? 1 : n <= 512 ? 8 : 16; }

// Dynamic shared memory above the default 48 KB needs the kernel's
// attribute raised first (a host call, so only then).
int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <typename T>
int launch_inv_diag(const T* l, T* dst, int e, int n, long long dst_mat,
                    long long dst_blk, int dst_ld, int full_out,
                    cudaStream_t s) {
  const size_t smem = (2 * NB * LDB + NB) * sizeof(T);
  const int err = set_smem((const void*)inv_diag<T>, smem);
  if (err) return err;
  inv_diag<T><<<dim3((n + NB - 1) / NB, e), INV_THREADS, smem, s>>>(
      l, dst, n, dst_mat, dst_blk, dst_ld, full_out);
  return (int)cudaGetLastError();
}

// the 64 x 64 inverses of every diagonal block into d (e, nb, 64, 64)
template <typename T>
int diag_inverses(const T* l, T* d, int e, int n, cudaStream_t s) {
  const int nb = (n + NB - 1) / NB;
  return launch_inv_diag<T>(l, d, e, n, (long long)nb * NB * NB, NB * NB, NB,
                            1, s);
}

template <typename T>
int launch_vec(const T* l, const T* d, const T* b, T* x, int e, int n,
               int mode, cudaStream_t s) {
  const int g = grid_g(n);
  const size_t smem = vec_smem_elems(n, g) * sizeof(T);
  int err = set_smem((const void*)solve_vec<T>, smem);
  if (err) return err;
  if (g > 8) {  // 16 CTAs per cluster is beyond the portable 8
    err = (int)cudaFuncSetAttribute(
        (const void*)solve_vec<T>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g, e);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = (int)cudaLaunchKernelEx(&cfg, solve_vec<T>, l, d, b, x, n, mode);
  if (err) return err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_strips(const T* l, const T* d, const T* b, T* x, int e, int n,
                  int m, int transpose, cudaStream_t s) {
  trsm_strips<T><<<dim3((m + NB - 1) / NB, e), THREADS, 0, s>>>(
      l, d, b, x, n, m, transpose);
  return (int)cudaGetLastError();
}

template <typename T>
int run_trsm(const T* l, const T* b, T* x, T* d, int e, int n, int m,
             int transpose, cudaStream_t s) {
  int err = diag_inverses<T>(l, d, e, n, s);
  if (err) return err;
  if (m == 1 && n <= VEC_MAX_N) {
    return launch_vec<T>(l, d, b, x, e, n, transpose ? 2 : 1, s);
  }
  return launch_strips<T>(l, d, b, x, e, n, m, transpose, s);
}

template <typename T>
int run_solve_psd(const T* l, const T* b, T* x, T* d, int e, int n, int m,
                  cudaStream_t s) {
  int err = diag_inverses<T>(l, d, e, n, s);
  if (err) return err;
  if (m == 1 && n <= VEC_MAX_N) return launch_vec<T>(l, d, b, x, e, n, 3, s);
  err = launch_strips<T>(l, d, b, x, e, n, m, 0, s);
  if (err) return err;
  return launch_strips<T>(l, d, x, x, e, n, m, 1, s);
}

template <typename T>
int run_tri_inv(const T* l, T* x, T* w, int e, int n, cudaStream_t s) {
  int err = launch_inv_diag<T>(l, x, e, n, (long long)n * n,
                               (long long)NB * n + NB, n, 0, s);
  if (err) return err;
  for (int sz = NB; sz < n; sz *= 2) {
    const int pairs = (n - sz + 2 * sz - 1) / (2 * sz);
    const int tiles = (sz / NB) * (sz / NB);
    const dim3 grid(tiles, pairs, e);
    level_t<T><<<grid, THREADS, 0, s>>>(l, x, w, n, sz);
    level_x<T><<<grid, THREADS, 0, s>>>(w, x, n, sz);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}

bool bad_shape(int e, int n, int m) {
  return n < 1 || m < 1 || e < 1 || e > 65535;
}

}  // namespace

// l (e, n, n) lower, b (e, n, m), x (e, n, m) output (must not alias b),
// d a workspace of e * ceil(n / 64) * 64 * 64 elements.
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int trsm_lower(const void* l, const void* b, void* x, void* d,
                          int e, int n, int m, int transpose, int is_f64,
                          void* stream) {
  if (bad_shape(e, n, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return run_trsm<double>(static_cast<const double*>(l),
                            static_cast<const double*>(b),
                            static_cast<double*>(x), static_cast<double*>(d),
                            e, n, m, transpose, s);
  }
  return run_trsm<float>(static_cast<const float*>(l),
                         static_cast<const float*>(b), static_cast<float*>(x),
                         static_cast<float*>(d), e, n, m, transpose, s);
}

// (L L^T) x = b: l (e, n, n), b and x (e, n, m) (x must not alias b), d as
// for trsm_lower.
extern "C" int trsm_solve_psd(const void* l, const void* b, void* x, void* d,
                              int e, int n, int m, int is_f64, void* stream) {
  if (bad_shape(e, n, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return run_solve_psd<double>(
        static_cast<const double*>(l), static_cast<const double*>(b),
        static_cast<double*>(x), static_cast<double*>(d), e, n, m, s);
  }
  return run_solve_psd<float>(static_cast<const float*>(l),
                              static_cast<const float*>(b),
                              static_cast<float*>(x), static_cast<float*>(d),
                              e, n, m, s);
}

// x = L^-1 (e, n, n), zero above the diagonal; w a workspace of e * n * n
// elements.
extern "C" int tri_inv_lower(const void* l, void* x, void* w, int e, int n,
                             int is_f64, void* stream) {
  if (bad_shape(e, n, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return run_tri_inv<double>(static_cast<const double*>(l),
                               static_cast<double*>(x),
                               static_cast<double*>(w), e, n, s);
  }
  return run_tri_inv<float>(static_cast<const float*>(l),
                            static_cast<float*>(x), static_cast<float*>(w), e,
                            n, s);
}
