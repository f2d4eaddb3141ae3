// Fused RBF GP posterior at L query lanes: mean, variance and optionally
// the mean Jacobian, for every output dim in one launch.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/gp_predict.py
// (_kernel, reached through gp_predict_lanes_pallas). For output dim e and
// lane l (the mask is folded into w_mean and w_var by the caller):
//
//   kv   = sf2_e exp(-0.5 ||x il_e - z_l il_e||^2)            (n)
//   mu   = w_mean_e . kv
//   var  = max(sf2_e - kv . (w_var_e kv), floor_e)
//   jac  = (X^T (kv * w_mean_e) - z_l sum(kv * w_mean_e)) il2_e   (d)
//
// What bounds it on an H100: operations. The quadratic form is 2 n^2 flops
// per lane and dim against (2 d + 2 e + e d) values moved per lane, so at
// the lane CEM's shapes (n = 64..128) it is about 100 flops per byte, above
// the f32 CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s = 20 flops per byte.
// What the design does about it: w_var (e n^2) is the Pallas kernel's VMEM
// resident; an SM's 227 KB holds it only up to n ~ 168 (e = 2, f32), so here
// each block keeps its lanes' kv (n x 32) in shared memory and streams w_var
// through a 16-row tile (gp_lanes.cuh), with four warps splitting the rows.
// Ragged lanes are masked in the kernel; nothing is padded.

#include "gp_lanes.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(gpl::NT)
gp_predict_kernel(const T* __restrict__ x, const T* __restrict__ wm,
                  const T* __restrict__ wv, const T* __restrict__ ils,
                  const T* __restrict__ ils2, const T* __restrict__ sf2,
                  const T* __restrict__ flr, const T* __restrict__ zz,
                  T* __restrict__ mu, T* __restrict__ var, T* __restrict__ jac,
                  int n, int d, int e_n, int L, int want_jac) {
  using namespace gpl;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<T> sm = carve(reinterpret_cast<T*>(smem_raw), n, d);
  const int l = threadIdx.x % LB, g = threadIdx.x / LB;
  const int lane = blockIdx.x * LB + l;
  load_rows(sm, x, n, d);
  for (int idx = threadIdx.x; idx < d * LB; idx += NT) {
    const int j = idx / LB, c = blockIdx.x * LB + idx % LB;
    sm.zb[idx] = c < L ? zz[(size_t)j * L + c] : T(0);
  }
  for (int e = 0; e < e_n; ++e) {
    T m, quad, s, rows[DMAX];
    posterior_dim(sm, wm + (size_t)e * n, wv + (size_t)e * n * n,
                  ils + (size_t)e * d, sf2[e], n, d, want_jac != 0, m, quad,
                  s, rows);
    if (g == 0 && lane < L) {
      mu[(size_t)e * L + lane] = m;
      var[(size_t)e * L + lane] = maxnan(sf2[e] - quad, flr[e]);
      if (want_jac) {
        for (int j = 0; j < d; ++j)
          jac[((size_t)e * d + j) * L + lane] =
              (rows[j] - sm.zb[j * LB + l] * s) * ils2[e * d + j];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* wm, const void* wv, const void* ils,
           const void* ils2, const void* sf2, const void* flr, const void* zz,
           void* mu, void* var, void* jac, int n, int d, int e_n, int L,
           int want_jac, cudaStream_t stream) {
  const size_t bytes = gpl::smem_bytes(n, d, sizeof(T));
  cudaError_t err = gpl::allow_smem(gp_predict_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (L + gpl::LB - 1) / gpl::LB;
  gp_predict_kernel<T><<<blocks, gpl::NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wm),
      static_cast<const T*>(wv), static_cast<const T*>(ils),
      static_cast<const T*>(ils2), static_cast<const T*>(sf2),
      static_cast<const T*>(flr), static_cast<const T*>(zz),
      static_cast<T*>(mu), static_cast<T*>(var), static_cast<T*>(jac), n, d,
      e_n, L, want_jac);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, d) support rows, wm (e, n), wv (e, n, n) masked posterior weights,
// ils / ils2 (e, d) inverse lengthscales and their squares, sf2 / flr (e,)
// signal variances and variance floors, zz (d, L) query lanes; out mu, var
// (e, L) and, when want_jac, jac (e, d, L). Returns cudaGetLastError().
extern "C" int gp_predict_lanes(const void* x, const void* wm, const void* wv,
                                const void* ils, const void* ils2,
                                const void* sf2, const void* flr,
                                const void* zz, void* mu, void* var, void* jac,
                                int n, int d, int e_n, int L, int want_jac,
                                int is_f64, void* stream) {
  if (n < 1 || d < 1 || d > gpl::DMAX || e_n < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(x, wm, wv, ils, ils2, sf2, flr, zz, mu, var, jac, n,
                          d, e_n, L, want_jac, s);
  return launch<float>(x, wm, wv, ils, ils2, sf2, flr, zz, mu, var, jac, n, d,
                       e_n, L, want_jac, s);
}
