// Masked, identity-padded RBF Gram matrix, batched over GP output dims, in
// one launch from the raw hyperparameters.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/gram.py
// (_gram_kernel, reached through rbf_gram_masked). For each output dim e:
//
//   K_e[i, j] = m_i m_j sf2_e exp(-0.5 max(n_i + n_j - 2 <xs_i, xs_j>, 0))
//               + delta_ij (m_i noise_e + 1 - m_i)
//
// with xs = x / ls_e, n_i = |xs_i|^2 (the matmul form of
// models/gp._masked_gram), ls_e = exp(log_ls_e), sf2_e = exp(2 log_sf_e)
// and noise_e = exp(2 log_noise_e) + 1e-6, all formed here once per CTA,
// so a refit's Gram is this launch and nothing else.
//
// What bounds it on an H100: the output. The work is 2 d + ~10 flops and
// one exp per pair against 4 or 8 bytes written per entry, so the kernel
// is a store of e n^2 values: 33.5 MB at n = 2048, e = 2 in f32, 0.010 ms
// at 3.35 TB/s; at the SQP path's n = 128 (131 KB) the launch latency sets
// the time, not the bytes.
// What the design does about it: CTAs only over the lower triangle of the
// 64 x 64 output tiles (i_blk >= j_blk) of each dim, so every exponential
// is computed once; a CTA stores its tile with 16-byte stores (4
// consecutive columns per thread, two stores in f64) and its mirror tile
// through a shared-memory transpose, so both stores are coalesced and K is
// exactly symmetric (one value written to both places; a diagonal tile's
// two halves are computed by the same expression under the swap, which is
// exact). The two 64-row input blocks over the lengthscales and their
// squared norms are staged in shared memory once per CTA. Plain stores, so
// K (33.5 MB at n = 2048) stays in the 50 MB L2 for the Cholesky that
// reads it next. Ragged edges take scalar stores; nothing is padded.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TB = 64;     // output tile edge
constexpr int NT = 256;    // threads: 16 x 16, each 4 rows x 4 columns
constexpr int DMAX = 32;   // largest input width staged in shared memory

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// 4 consecutive entries of row `row` from column `col` on: one 16-byte
// store (two in f64) where the row is 16-byte aligned and all 4 lie in the
// matrix, else a scalar store per entry inside it.
template <typename T>
__device__ __forceinline__ void store_row4(T* out, int n, int row, int col,
                                           const T (&v)[4], bool vec) {
  if (row >= n) return;
  T* p = out + (size_t)row * n + col;
  if (vec && col + 3 < n) {
    st4(p, v);
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (col + q < n) p[q] = v[q];
  }
}

template <typename T>
struct GramSmem {
  union {
    struct {
      T xi[DMAX][TB];   // the row block over the lengthscales, transposed
      T xj[DMAX][TB];   // the column block
    } in;
    T tile[TB][TB + 1]; // the computed tile, read back for its mirror
  } u;
  T ni[TB], nj[TB], mi[TB], mj[TB];
  T ls[DMAX];
  T sf2, noise;
};

template <typename T>
__global__ void __launch_bounds__(NT)
gram_kernel(const T* __restrict__ x, const T* __restrict__ mask,
            const T* __restrict__ log_ls, const T* __restrict__ log_sf,
            const T* __restrict__ log_noise, T* __restrict__ out, int n,
            int d) {
  __shared__ __align__(16) GramSmem<T> sm;
  const int e = blockIdx.y;
  // lower-triangle tile t -> (bi, bj), bi >= bj, t = bi (bi + 1) / 2 + bj
  const int t = blockIdx.x;
  int bi = (int)((sqrt(8.0 * t + 1.0) - 1.0) * 0.5);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const int bj = t - bi * (bi + 1) / 2;
  const int i0 = bi * TB, j0 = bj * TB;
  const int tid = threadIdx.x;
  const int tc = tid % 16, tr = tid / 16;

  // hyperparameters, once per CTA
  if (tid < d) sm.ls[tid] = exp_(log_ls[(size_t)e * d + tid]);
  if (tid == DMAX) {
    sm.sf2 = exp_(T(2) * log_sf[e]);
    sm.noise = exp_(T(2) * log_noise[e]) + T(1e-6);
  }
  __syncthreads();
  for (int idx = tid; idx < 2 * TB * d; idx += NT) {
    const int half = idx / (TB * d), r = (idx / d) % TB, k = idx % d;
    const int gr = (half ? j0 : i0) + r;
    const T v = gr < n ? x[(size_t)gr * d + k] / sm.ls[k] : T(0);
    if (half) {
      sm.u.in.xj[k][r] = v;
    } else {
      sm.u.in.xi[k][r] = v;
    }
  }
  if (tid < TB) {
    sm.mi[tid] = i0 + tid < n ? mask[i0 + tid] : T(0);
  } else if (tid < 2 * TB) {
    sm.mj[tid - TB] = j0 + tid - TB < n ? mask[j0 + tid - TB] : T(0);
  }
  __syncthreads();
  if (tid < TB) {
    T s = T(0);
    for (int k = 0; k < d; ++k) s += sm.u.in.xi[k][tid] * sm.u.in.xi[k][tid];
    sm.ni[tid] = s;
  } else if (tid < 2 * TB) {
    const int r = tid - TB;
    T s = T(0);
    for (int k = 0; k < d; ++k) s += sm.u.in.xj[k][r] * sm.u.in.xj[k][r];
    sm.nj[r] = s;
  }
  __syncthreads();

  // rows tr + 16 p, columns 4 tc + q of the tile
  T v[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) v[p][q] = T(0);
  for (int k = 0; k < d; ++k) {
    T a[4], b[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) a[p] = sm.u.in.xi[k][tr + 16 * p];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = sm.u.in.xj[k][4 * tc + q];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[p][q] += a[p] * b[q];
  }
  const T s2 = sm.sf2, nz = sm.noise;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = tr + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * tc + q;
      T d2 = sm.ni[r] + sm.nj[c] - T(2) * v[p][q];
      d2 = d2 > T(0) ? d2 : T(0);
      T kv = s2 * exp_(T(-0.5) * d2);
      kv = kv * (sm.mi[r] * sm.mj[c]);
      if (i0 + r == j0 + c) kv = kv + (sm.mi[r] * nz + (T(1) - sm.mi[r]));
      v[p][q] = kv;
    }
  }

  const bool vec = ((size_t)n * sizeof(T)) % 16 == 0;
  T* oute = out + (size_t)e * n * n;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    store_row4(oute, n, i0 + tr + 16 * p, j0 + 4 * tc, v[p], vec);
  if (bi == bj) return;   // a diagonal tile is its own mirror

  __syncthreads();        // every thread is done with the inputs
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) sm.u.tile[tr + 16 * p][4 * tc + q] = v[p][q];
  __syncthreads();
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int c = tr + 16 * p;   // the mirror's row: column c of the tile
    T m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = sm.u.tile[4 * tc + q][c];
    store_row4(oute, n, j0 + c, i0 + 4 * tc, m, vec);
  }
}

template <typename T>
int launch(const void* x, const void* mask, const void* log_ls,
           const void* log_sf, const void* log_noise, void* out, int e, int n,
           int d, cudaStream_t stream) {
  const int nb = (n + TB - 1) / TB;
  const dim3 grid(nb * (nb + 1) / 2, e);
  gram_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask),
      static_cast<const T*>(log_ls), static_cast<const T*>(log_sf),
      static_cast<const T*>(log_noise), static_cast<T*>(out), n, d);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, d), mask (n,), log_ls (e, d) log lengthscales, log_sf (e,) log
// signal stds, log_noise (e,) log noise stds, out (e, n, n). Returns
// cudaGetLastError().
extern "C" int gram_rbf_masked(const void* x, const void* mask,
                               const void* log_ls, const void* log_sf,
                               const void* log_noise, void* out, int e, int n,
                               int d, int is_f64, void* stream) {
  if (d > DMAX || d < 1 || n < 1 || e < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(x, mask, log_ls, log_sf, log_noise, out, e, n, d, s);
  return launch<float>(x, mask, log_ls, log_sf, log_noise, out, e, n, d, s);
}
