// Fused RBF GP posterior at L query lanes: mean, variance and optionally
// the mean Jacobian, for every output dim in one launch, on a posterior
// prepared once per model (ops/kernels/gp_predict.py: LanePosterior).
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/gp_predict.py
// (_kernel, reached through gp_predict_lanes_pallas). For output dim e and
// lane l, z_l in raw coordinates (the wrapper folds any input scale into
// the rows and lengthscales, and the mask into w_mean and w_var):
//
//   kv   = sf2_e exp(-0.5 ||x il_e - z_l il_e||^2)                (n)
//   mu   = w_mean_e . kv
//   var  = max(sf2_e - kv . (w_var_e kv), floor_e)
//   jac  = (X^T (kv * w_mean_e) - z_l mu) il2_e                   (d)
//
// What bounds it on an H100: operations. The quadratic form is 2 n^2 flops
// per lane and dim against (2 d + 2 e + e d) values moved per lane, about
// 100 flops per byte at the lane CEM's n = 64..128, above the f32
// CUDA-core ridge of 67 TFLOP/s / 3.35 TB/s = 20 flops per byte; at the
// final passes' L = 256 lanes the work is microseconds, so the launch and
// the latency of one block's chain set the time.
// What the design does about it: it is cem_score's block posterior
// (gp_lanes.cuh), one output dim per block, the dims on the grid (blocks =
// lane blocks x e: 16 at L = 256 in blocks of 32 lanes and 128 threads;
// 64 lanes and 256 threads once that fills the SMs). The dim's W^T (n <=
// 128 f32, 89 f64: 64 KB) is copied into shared memory with cp.async,
// issued first so the copy overlaps the staging and the kv exponentials;
// above that it streams in 16-deep slices. The quadratic form is the
// register-tiled product V = W KV (4 x 4 per thread from vector
// shared-memory loads), and the mean and the Jacobian's rows come from the
// same kv between the same two barriers. Ragged lanes are masked in the
// kernel; nothing is padded. IEEE FMA on the CUDA cores, no TF32.

#include "gp_lanes.cuh"

namespace {

using gpl::DMAX;
using gpl::KS;
using gpl::pad4;

constexpr size_t RESIDENT_MAX = 64 * 1024;  // bytes of one dim's W kept resident

// Shared memory of a block, in elements: kv (n x LB), W (resident: n x
// pad4(n); streamed: one KS x RT slice), the per-warp partial quadratic
// forms (NT / 32 x LB), the mean and Jacobian rows ((1 + DMAX) x LB), the
// support rows x and the dim's x / ls (n x d each) and w_mean (n). The
// arrays read with vector loads come first, each a multiple of 4 elements.
template <int NT, int LB>
size_t smem_elems(int n, int d, bool resident) {
  return (size_t)n * LB +
         (resident ? (size_t)n * pad4(n) : KS * gpl::rows_per_tile<NT, LB>()) +
         (NT / 32) * LB + (1 + DMAX) * LB + 2 * (size_t)n * d + n;
}

template <typename T, int NT, int LB>
__global__ void __launch_bounds__(NT)
gp_predict_kernel(const T* __restrict__ x, const T* __restrict__ xil,
                  const T* __restrict__ wm, const T* __restrict__ wvt,
                  const T* __restrict__ ils, const T* __restrict__ ils2,
                  const T* __restrict__ sf2, const T* __restrict__ flr,
                  const T* __restrict__ zz, T* __restrict__ mu,
                  T* __restrict__ var, T* __restrict__ jac, int n, int d,
                  int L, int want_jac, int resident) {
  static_assert(NT / LB == 4, "four threads per lane write its outputs");
  constexpr int RT = gpl::rows_per_tile<NT, LB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int e = blockIdx.y, np = pad4(n);
  T* kv = reinterpret_cast<T*>(smem_raw);
  T* wsh = kv + (size_t)n * LB;
  T* red = wsh + (resident ? (size_t)n * np : KS * RT);
  T* aug = red + (NT / 32) * LB;
  T* xs = aug + (1 + DMAX) * LB;
  T* xl = xs + (size_t)n * d;
  T* wms = xl + (size_t)n * d;

  const int tid = threadIdx.x;
  const int l = tid % LB, g = tid / LB;
  const int lane = blockIdx.x * LB + l;
  const bool live = lane < L;
  const T* wv_e = wvt + (size_t)e * n * n;

  // the dim's W in flight while the rest is staged and kv computed
  if (resident) gpl::load_w_async<T, NT>(wsh, wv_e, n, 1);
  const T* xe = xil + (size_t)e * n * d;
  for (int idx = tid; idx < n * d; idx += NT) {
    xl[idx] = xe[idx];
    if (want_jac) xs[idx] = x[idx];
  }
  for (int idx = tid; idx < n; idx += NT) wms[idx] = wm[(size_t)e * n + idx];
  T z[DMAX];
#pragma unroll
  for (int j = 0; j < DMAX; ++j)
    z[j] = live && j < d ? zz[(size_t)j * L + lane] : T(0);
  __syncthreads();

  const T s2 = sf2[e];
  gpl::kv_stage<T, NT, LB>(kv, xl, z, ils + (size_t)e * d, s2, n, d);
  gpl::cp_async_wait_all();
  __syncthreads();
  gpl::mean_rows<T, NT, LB>(aug, kv, xs, wms, n, d, want_jac ? 1 + d : 1);
  const T quad = gpl::quad_form<T, NT, LB>(kv, wsh, wv_e, resident != 0,
                                           wsh, red, n);
  if (!live) return;
  // the lane's four threads write its outputs: the mean, the variance and
  // the Jacobian's rows, two each
  const T m = aug[l];
  if (g == 0) mu[(size_t)e * L + lane] = m;
  if (g == 1) var[(size_t)e * L + lane] = gpl::maxnan(s2 - quad, flr[e]);
  if (want_jac) {
#pragma unroll
    for (int j = 0; j < DMAX; ++j) {
      if (j >= d) break;
      if (g == 2 + j % 2) {
        jac[((size_t)e * d + j) * L + lane] =
            (aug[(1 + j) * LB + l] - z[j] * m) * ils2[e * d + j];
      }
    }
  }
}

template <typename T, int NT, int LB>
int launch_lb(const void* x, const void* xil, const void* wm, const void* wvt,
              const void* ils, const void* ils2, const void* sf2,
              const void* flr, const void* zz, void* mu, void* var, void* jac,
              int n, int d, int e_n, int L, int want_jac, bool resident,
              size_t bytes, cudaStream_t stream) {
  cudaError_t err = gpl::allow_smem(gp_predict_kernel<T, NT, LB>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + LB - 1) / LB, e_n);
  gp_predict_kernel<T, NT, LB><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(xil),
      static_cast<const T*>(wm), static_cast<const T*>(wvt),
      static_cast<const T*>(ils), static_cast<const T*>(ils2),
      static_cast<const T*>(sf2), static_cast<const T*>(flr),
      static_cast<const T*>(zz), static_cast<T*>(mu), static_cast<T*>(var),
      static_cast<T*>(jac), n, d, L, want_jac, (int)resident);
  return (int)cudaGetLastError();
}

// 64 lanes and 256 threads a block where the grid still has a block per
// SM and the block's shared memory holds them, else 32 lanes and 128.
template <typename T>
int launch(const void* x, const void* xil, const void* wm, const void* wvt,
           const void* ils, const void* ils2, const void* sf2,
           const void* flr, const void* zz, void* mu, void* var, void* jac,
           int n, int d, int e_n, int L, int want_jac, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const bool resident = (size_t)n * pad4(n) * sizeof(T) <= RESIDENT_MAX;
  const size_t b64 = smem_elems<256, 64>(n, d, resident) * sizeof(T);
  if ((long)((L + 63) / 64) * e_n >= sms && b64 <= gpl::SMEM_MAX) {
    return launch_lb<T, 256, 64>(x, xil, wm, wvt, ils, ils2, sf2, flr, zz, mu,
                                 var, jac, n, d, e_n, L, want_jac, resident,
                                 b64, stream);
  }
  const size_t b32 = smem_elems<128, 32>(n, d, resident) * sizeof(T);
  return launch_lb<T, 128, 32>(x, xil, wm, wvt, ils, ils2, sf2, flr, zz, mu,
                               var, jac, n, d, e_n, L, want_jac, resident,
                               b32, stream);
}

}  // namespace

// The fields of a LanePosterior: x (n, d) support rows in raw coordinates,
// xil (e, n, d) the rows over each dim's lengthscales, wm (e, n) and wvt
// (e, n, n) the masked weights (w_var transposed), ils / ils2 (e, d)
// inverse lengthscales and their squares, sf2 / flr (e,) signal variances
// and variance floors; zz (d, L) query lanes; out mu, var (e, L) and, when
// want_jac, jac (e, d, L). Returns cudaGetLastError() (cudaErrorInvalidValue
// where one block's shared memory cannot hold the model).
extern "C" int gp_predict_prepared(const void* x, const void* xil,
                                   const void* wm, const void* wvt,
                                   const void* ils, const void* ils2,
                                   const void* sf2, const void* flr,
                                   const void* zz, void* mu, void* var,
                                   void* jac, int n, int d, int e_n, int L,
                                   int want_jac, int is_f64, void* stream) {
  if (n < 1 || d < 1 || d > DMAX || e_n < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(x, xil, wm, wvt, ils, ils2, sf2, flr, zz, mu, var,
                          jac, n, d, e_n, L, want_jac, s);
  return launch<float>(x, xil, wm, wvt, ils, ils2, sf2, flr, zz, mu, var, jac,
                       n, d, e_n, L, want_jac, s);
}
