// Left-looking block-column lower Cholesky for large matrices, batched over
// matrices: the tier above cholesky.cu's n <= 1024.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/cholesky_hbm.py
// (_chol_hbm_kernel, reached through cholesky_hbm). Same contract: A (e, n, n)
// SPD -> L (e, n, n) lower with L L^T = A and zeros above the diagonal, only
// the lower triangle of A is read, any n >= 1 (the ragged last block column is
// masked, nothing is padded), and a non-positive pivot gives NaN from that
// column on, which every later block column inherits through its update; the
// kernel never raises and never clamps.
//
// Algorithm, per block column k of width P = 64 (host loop, four launches per
// column, every launch batched over the e matrices):
//   1. update_partial: the GEMM-NT update S_k = A[k0:, k0:k0+P] -
//      L[k0:, :k0] L[k0:k0+P, :k0]^T. Rows of the column are cut into 64-row
//      tiles and the depth k0 into up to max_splits chunks (the wrapper
//      passes 16); each CTA writes the partial product of its (tile, chunk)
//      to a workspace W (split, e, n, P) (64 x 64 output tile, 16-deep
//      shared-memory slices, 256 threads with 4 x 4 outputs each). The split
//      keeps ~2 CTAs per SM busy when the column has few rows left but a long
//      depth (the left-looking update's shape late in the factorization),
//      and the sums stay deterministic: reduce_column adds the partials in a
//      fixed order and writes S_k into L's block column, in one coalesced
//      pass over many CTAs.
//   2. factor_diag: one CTA per matrix reads the P x P diagonal block of S_k
//      into shared memory and factors it in 16-wide sub-blocks: one warp
//      factors the 16 x 16 diagonal sub-block in registers (a row per lane,
//      columns exchanged by shuffles, no block barrier), the rows below it
//      inside the block are solved one per thread, and the rest of the block
//      takes a rank-16 update; three barriers per sub-block, 12 per block
//      column.
//   3. solve_strip: the strip below the diagonal block, L = S L_kk^-T, in
//      64-row tiles staged through shared memory; one row per thread by
//      substitution against L_kk, column by column so that a step's updates
//      are independent.
// FMA on the CUDA cores in the matrices' own type (f32 or f64; no TF32, no
// library call).
//
// Why these sizes: P = 64 keeps the diagonal block (33 KB in f64), a strip
// tile (66 KB in f64 with L_kk) and a strip row (64 registers, 128 in f64)
// in one SM's reach, so one design serves both types. The serial part of a
// Cholesky is its chain of pivots; a one-column-per-step diagonal
// factorization pays a block barrier per pivot (2,048 of them at n = 2048),
// so the pivots run inside one warp on 16-wide sub-blocks and the barriers
// fall to one per 5 columns. The TPU kernel's choices (P = 256 panels held
// whole in VMEM, double-buffered DMA of finished columns) do not carry
// over: an SM holds a 64-wide strip, not an (n, 256) column, and Hopper's
// L2 (50 MB) holds the whole factor at n = 2048, so the finished columns
// are re-read from L2.
//
// What bounds it on an H100: n^3 / 3 flops per matrix (5.7 GFLOP for e = 2 at
// n = 2048, 0.085 ms at the 67 TFLOP/s f32 peak) against 2 e n^2 words of
// traffic; the bound is operations. What stands between this kernel and that
// bound: 4 n / 64 dependent launches (128 at n = 2048), the diagonal step on
// one SM per matrix and a CUDA-core GEMM. Tensor-core (wgmma) tiles, TMA
// loads and a fused diagonal step are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int P = 64;             // block-column width
constexpr int TM = 64;            // GEMM output tile rows (== P columns)
constexpr int TK = 16;            // GEMM depth slice
constexpr int THREADS = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int SUB = 16;           // sub-block width of the diagonal step
constexpr int DIAG_THREADS = 512;
constexpr int MIN_CHUNK = 128;    // least depth per split of the update
constexpr int TARGET_CTAS = 264;  // ~2 CTAs per SM on a 132-SM H100
constexpr int LD = P + 1;         // padded row stride of the diagonal block

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }

// acc[q][w] += sum_{p in [k_lo, k_hi)} A(r, p) B(c, p) with r = ty + 16 q and
// c = tx + 16 w: the 64 x 64 NT product of two row-major operands given by
// loaders that return 0 outside their matrix.
template <typename T, typename LA, typename LB>
__device__ __forceinline__ void nt_product(T (&acc)[4][4], int k_lo, int k_hi,
                                           const LA& load_a, const LB& load_b) {
  __shared__ T as[TK][TM + 1];
  __shared__ T bs[TK][P + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  for (int p0 = k_lo; p0 < k_hi; p0 += TK) {
    for (int idx = tid; idx < TM * TK; idx += THREADS) {
      const int r = idx / TK, c = idx % TK;
      const int p = p0 + c;
      const bool in = p < k_hi;
      as[c][r] = in ? load_a(r, p) : T(0);
      bs[c][r] = in ? load_b(r, p) : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      T av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        av[q] = as[kk][ty + 16 * q];
        bv[q] = bs[kk][tx + 16 * q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[q][w] += av[q] * bv[w];
      }
    }
    __syncthreads();
  }
}

// Rows [row0, row_end) of one matrix's L, as a GEMM operand.
template <typename T>
struct LRows {
  const T* l;
  int n, row0, row_end;
  __device__ T operator()(int r, int p) const {
    const int i = row0 + r;
    return i < row_end ? l[(size_t)i * n + p] : T(0);
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
update_partial(const T* __restrict__ l_all, T* __restrict__ w, int e, int n,
               int k0, int kb, int chunk) {
  const int m = blockIdx.z % e, s = blockIdx.z / e;
  const T* l = l_all + (size_t)m * n * n;
  const int r0 = blockIdx.x * TM;          // row offset inside [k0, n)
  const int k_lo = s * chunk;
  const int k_hi = min(k0, k_lo + chunk);
  T acc[4][4] = {};
  nt_product<T>(acc, k_lo, k_hi, LRows<T>{l, n, k0 + r0, n},
                LRows<T>{l, n, k0, k0 + kb});
  T* ws = w + ((size_t)s * e + m) * n * P;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + ty + 16 * q;
    if (k0 + r >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) ws[(size_t)r * P + tx + 16 * c] = acc[q][c];
  }
}

template <typename T>
__global__ void __launch_bounds__(DIAG_THREADS)
factor_diag(T* __restrict__ l_all, int n, int k0, int kb) {
  __shared__ T s[P][LD];   // S_kk, factored in place into L_kk
  const int tid = threadIdx.x;
  T* l = l_all + (size_t)blockIdx.x * n * n;
  for (int idx = tid; idx < P * P; idx += DIAG_THREADS) {
    const int i = idx / P, j = idx % P;
    T v = (i == j) ? T(1) : T(0);   // identity past kb
    if (i < kb && j < kb) v = j <= i ? l[(size_t)(k0 + i) * n + k0 + j] : T(0);
    s[i][j] = v;
  }
  __syncthreads();
  for (int c0 = 0; c0 < P; c0 += SUB) {
    // 1. warp 0 factors the SUB x SUB diagonal sub-block in registers, one
    //    row per lane, exchanging columns by shuffles (no block barrier)
    if (tid < 32) {
      const int r = tid;
      T row[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        row[j] = (r < SUB && j <= r) ? s[c0 + r][c0 + j] : T(0);
      }
#pragma unroll
      for (int k = 0; k < SUB; ++k) {
        const T v = __shfl_sync(0xffffffffu, row[k], k);
        const T d = v > T(0) ? sqrt_(v) : T(NAN);
        if (r == k) {
          row[k] = d;
        } else if (r > k) {
          row[k] /= d;
        }
#pragma unroll
        for (int j = k + 1; j < SUB; ++j) {
          const T ljk = __shfl_sync(0xffffffffu, row[k], j);
          if (r >= j) row[j] -= row[k] * ljk;
        }
      }
      if (r < SUB) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          if (j <= r) s[c0 + r][c0 + j] = row[j];
        }
      }
    }
    __syncthreads();
    // 2. the rows below it inside the diagonal block, one thread per row:
    //    L[i, c0:c0+SUB] = S[i, c0:c0+SUB] L_sub^-T by substitution
    const int below = P - c0 - SUB;
    if (tid < below) {
      const int i = c0 + SUB + tid;
      T x[SUB];
#pragma unroll
      for (int j = 0; j < SUB; ++j) x[j] = s[i][c0 + j];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        x[j] /= s[c0 + j][c0 + j];
#pragma unroll
        for (int q = j + 1; q < SUB; ++q) x[q] -= x[j] * s[c0 + q][c0 + j];
      }
#pragma unroll
      for (int j = 0; j < SUB; ++j) s[i][c0 + j] = x[j];
    }
    __syncthreads();
    // 3. the rank-SUB update of the lower triangle still to factor
    for (int idx = tid; idx < below * below; idx += DIAG_THREADS) {
      const int i = c0 + SUB + idx / below, j = c0 + SUB + idx % below;
      if (j > i) continue;
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < SUB; ++p) acc += s[i][c0 + p] * s[j][c0 + p];
      s[i][j] -= acc;
    }
    __syncthreads();
  }
  for (int idx = tid; idx < P * P; idx += DIAG_THREADS) {
    const int i = idx / P, j = idx % P;
    if (i < kb && j < kb) {
      l[(size_t)(k0 + i) * n + k0 + j] = j <= i ? s[i][j] : T(0);
    }
  }
}

// S = A[k0:, k0:k0+kb] minus the update's partial sums, written into L's
// block column (lower part of the diagonal block, all rows below it):
// one coalesced pass over many CTAs, so the two serial consumers below read
// a plain column.
template <typename T>
__global__ void __launch_bounds__(THREADS)
reduce_column(const T* __restrict__ a_all, T* __restrict__ l_all,
              const T* __restrict__ w, int e, int n, int k0, int kb,
              int splits) {
  const int m = blockIdx.y;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  const int r = idx / P, c = idx % P;   // row k0 + r, column k0 + c
  if (k0 + r >= n || c >= kb || (r < kb && c > r)) return;
  const size_t at = (size_t)m * n * n + (size_t)(k0 + r) * n + k0 + c;
  T v = a_all[at];
  for (int t = 0; t < splits; ++t) {
    v -= w[(((size_t)t * e + m) * n + r) * P + c];
  }
  l_all[at] = v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
solve_strip(T* __restrict__ l_all, int n, int k0, int kb) {
  extern __shared__ unsigned char smem_raw[];
  T (*lkk)[LD] = reinterpret_cast<T (*)[LD]>(smem_raw);  // L_kk, identity
  T (*xs)[LD] = lkk + P;                                 // 64 strip rows
  T* l = l_all + (size_t)blockIdx.y * n * n;
  const int row0 = k0 + kb + blockIdx.x * TM;
  for (int idx = threadIdx.x; idx < P * P; idx += THREADS) {
    const int i = idx / P, j = idx % P;
    lkk[i][j] = (i < kb && j < kb) ? l[(size_t)(k0 + i) * n + k0 + j]
                                   : (i == j ? T(1) : T(0));
    xs[i][j] = (row0 + i < n && j < kb) ? l[(size_t)(row0 + i) * n + k0 + j]
                                        : T(0);
  }
  __syncthreads();
  // one row per thread of the first two warps: x = S_i L_kk^-T, column by
  // column so that each step's updates are independent of each other
  if (threadIdx.x < TM) {
    T x[P];
#pragma unroll
    for (int c = 0; c < P; ++c) x[c] = xs[threadIdx.x][c];
#pragma unroll
    for (int c = 0; c < P; ++c) {
      x[c] /= lkk[c][c];
#pragma unroll
      for (int q = c + 1; q < P; ++q) x[q] -= x[c] * lkk[q][c];
    }
#pragma unroll
    for (int c = 0; c < P; ++c) xs[threadIdx.x][c] = x[c];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < TM * P; idx += THREADS) {
    const int i = idx / P, j = idx % P;
    if (row0 + i < n && j < kb) l[(size_t)(row0 + i) * n + k0 + j] = xs[i][j];
  }
}

template <typename T>
int run(const T* a, T* l, T* w, int e, int n, int max_splits,
        cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(l, 0, sizeof(T) * (size_t)e * n * n, st);
  if (err != cudaSuccess) return (int)err;
  const int strip_smem = 2 * P * LD * (int)sizeof(T);   // 66.5 KB in f64
  err = cudaFuncSetAttribute(solve_strip<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             strip_smem);
  if (err != cudaSuccess) return (int)err;
  for (int k0 = 0; k0 < n; k0 += P) {
    const int kb = n - k0 < P ? n - k0 : P;
    const int row_tiles = (n - k0 + TM - 1) / TM;
    int splits = 0;
    if (k0 > 0) {
      const int base = row_tiles * e;
      int want = (TARGET_CTAS + base - 1) / base;
      const int most = k0 / MIN_CHUNK > 1 ? k0 / MIN_CHUNK : 1;
      if (want > most) want = most;
      if (want > max_splits) want = max_splits;
      if (want < 1) want = 1;
      int chunk = (k0 + want - 1) / want;
      chunk = (chunk + TK - 1) / TK * TK;
      splits = (k0 + chunk - 1) / chunk;
      update_partial<T><<<dim3(row_tiles, 1, e * splits), THREADS, 0, st>>>(
          l, w, e, n, k0, kb, chunk);
    }
    const int col_ctas = ((n - k0) * P + THREADS - 1) / THREADS;
    reduce_column<T><<<dim3(col_ctas, e), THREADS, 0, st>>>(a, l, w, e, n, k0,
                                                            kb, splits);
    factor_diag<T><<<e, DIAG_THREADS, 0, st>>>(l, n, k0, kb);
    const int rest = n - k0 - kb;
    if (rest > 0) {
      solve_strip<T><<<dim3((rest + TM - 1) / TM, e), THREADS, strip_smem,
                       st>>>(l, n, k0, kb);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The block-column width; the wrapper sizes its workspace with it.
extern "C" int cholesky_hbm_panel() { return P; }

// a (e, n, n) input, l (e, n, n) output (must not alias a); w a workspace of
// max_splits * e * n * P elements.
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int cholesky_hbm(const void* a, void* l, void* w, int e, int n,
                            int max_splits, int is_f64, void* stream) {
  if (n < 1 || e < 1 || e > 65535 || max_splits < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)e * max_splits > 65535) max_splits = 65535 / e;
  if (max_splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    return run<double>(static_cast<const double*>(a), static_cast<double*>(l),
                       static_cast<double*>(w), e, n, max_splits, s);
  }
  return run<float>(static_cast<const float*>(a), static_cast<float*>(l),
                    static_cast<float*>(w), e, n, max_splits, s);
}
