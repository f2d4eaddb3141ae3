// Masked, identity-padded RBF Gram matrix, batched over GP output dims.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/gram.py
// (_gram_kernel, reached through rbf_gram_masked). For each output dim e:
//
//   K_e[i, j] = m_i m_j sf2_e exp(-0.5 ||x_i / ls_e - x_j / ls_e||^2)
//               + delta_ij (m_i noise_e + 1 - m_i)
//
// with the squared distance in the matmul form n_i + n_j - 2 <x_i, x_j> that
// models/gp._masked_gram uses (noise_e already includes the 1e-6 jitter).
//
// What bounds it on an H100: the output. The work is 2d+~10 flops and one
// exp per entry, against 4 or 8 bytes written per entry, so at every size the
// kernel is a store of e*n*n values; at the refit's shapes (e=2, n=128..512)
// that is 0.13-4 MB, well under the launch latency at 3.35 TB/s.
// What the design does about it: each CTA owns one 32x32 output tile of one
// dim; the two 32-row input blocks (pre-scaled by the lengthscales) and
// their squared norms are staged once in shared memory, and each thread
// writes 4 entries of one column, so consecutive threads store consecutive
// addresses. Ragged edges are masked in the kernel; nothing is padded.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;  // output tile edge
constexpr int ROWS = 8;   // thread rows; each thread computes TILE / ROWS rows
constexpr int DMAX = 32;  // largest input width staged in shared memory

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }

template <typename T>
__global__ void __launch_bounds__(TILE * ROWS)
gram_kernel(const T* __restrict__ x, const T* __restrict__ mask,
            const T* __restrict__ ls, const T* __restrict__ sf2,
            const T* __restrict__ noise, T* __restrict__ out, int n, int d) {
  __shared__ T xi[TILE][DMAX + 1];
  __shared__ T xj[TILE][DMAX + 1];
  __shared__ T ni[TILE], nj[TILE], mi[TILE], mj[TILE];

  const int e = blockIdx.z;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  const T* lse = ls + (size_t)e * d;

  for (int idx = tid; idx < TILE * d; idx += TILE * ROWS) {
    const int r = idx / d, k = idx % d;
    const int gi = i0 + r, gj = j0 + r;
    xi[r][k] = gi < n ? x[(size_t)gi * d + k] / lse[k] : T(0);
    xj[r][k] = gj < n ? x[(size_t)gj * d + k] / lse[k] : T(0);
  }
  __syncthreads();
  if (tid < TILE) {
    T s = T(0);
    for (int k = 0; k < d; ++k) s += xi[tid][k] * xi[tid][k];
    ni[tid] = s;
    mi[tid] = i0 + tid < n ? mask[i0 + tid] : T(0);
  } else if (tid < 2 * TILE) {
    const int r = tid - TILE;
    T s = T(0);
    for (int k = 0; k < d; ++k) s += xj[r][k] * xj[r][k];
    nj[r] = s;
    mj[r] = j0 + r < n ? mask[j0 + r] : T(0);
  }
  __syncthreads();

  const T s2 = sf2[e];
  const T nz = noise[e];
  const int j = j0 + tx;
  for (int r = ty; r < TILE; r += ROWS) {
    const int i = i0 + r;
    if (i >= n || j >= n) continue;
    T cross = T(0);
    for (int k = 0; k < d; ++k) cross += xi[r][k] * xj[tx][k];
    T d2 = ni[r] + nj[tx] - T(2) * cross;
    d2 = d2 > T(0) ? d2 : T(0);
    T kv = s2 * exp_(T(-0.5) * d2);
    kv = kv * (mi[r] * mj[tx]);
    if (i == j) kv = kv + (mi[r] * nz + (T(1) - mi[r]));
    out[((size_t)e * n + i) * n + j] = kv;
  }
}

}  // namespace

// x (n, d), mask (n,), ls (e, d) lengthscales, sf2 (e,) signal variances,
// noise (e,) noise variance + jitter, out (e, n, n). Returns cudaGetLastError().
extern "C" int gram_rbf_masked(const void* x, const void* mask, const void* ls,
                               const void* sf2, const void* noise, void* out,
                               int e, int n, int d, int is_f64, void* stream) {
  if (d > DMAX || d < 1 || n < 1 || e < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(TILE, ROWS);
  const dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE, e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    gram_kernel<double><<<grid, block, 0, s>>>(
        static_cast<const double*>(x), static_cast<const double*>(mask),
        static_cast<const double*>(ls), static_cast<const double*>(sf2),
        static_cast<const double*>(noise), static_cast<double*>(out), n, d);
  } else {
    gram_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(mask),
        static_cast<const float*>(ls), static_cast<const float*>(sf2),
        static_cast<const float*>(noise), static_cast<float*>(out), n, d);
  }
  return (int)cudaGetLastError();
}
