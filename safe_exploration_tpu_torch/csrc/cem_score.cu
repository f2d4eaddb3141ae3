// Whole-tube constrained-CEM score per sample lane, in one launch.
//
// Replaces the Pallas kernel safe_exploration_tpu/ops/pallas/cem_score.py
// (_kernel, reached through tube_score_lanes_pallas). For every lane (a
// control sequence u (n_var,) from an initial state x0 (2,)) it runs the
// n_s = 2 ellipsoid tube of sqp_lanes._rollout_lanes and scores it:
//
//   stage 0        point step: p = a x0 + b u_0 + mu, Q = diag(2 hw^2),
//                  hw = c (sqrt(var + noise))
//   stages 1..T-1  GP mean, variance and mean Jacobian at (p, u_t);
//                  H = a + J_x + (b + J_u) k_fb, Q_lin = H Q H^T;
//                  r^2 = lambda_max(Q S^T S) in closed form (2x2);
//                  Q = (Q_lin (+) conf box) (+) Taylor box, each a diagonal
//                  Minkowski sum with trace floor 1e-30
//   viol           sum over stages and the terminal set of
//                  max(h_i p + sqrt(h_i Q h_i) - h_i, 0)
//   cost           tracking (stage, control and terminal terms) or
//                  exploration (-scale * sum sqrt(var))
//
// The GP runs in raw input coordinates: the caller folds z_scale into the
// support rows and lengthscales, so the Jacobian needs no chain rule.
//
// What bounds it on an H100: operations. Each of the T stages evaluates the
// posterior for both output dims, 2 n^2 flops each for the variance's
// quadratic form kv^T W kv, about 1.3 GFLOP at the lane CEM's 16,384 lanes
// and n = 64, against 4 bytes in and out per lane and step. What the design
// does about it: a block of 256 threads owns 64 lanes (32 where the
// cross-covariances of 64 lanes do not fit in shared memory); the quadratic
// form is a register-tiled product V = W KV over (rows x lanes) tiles, 4
// rows x 4 lanes per thread from two vector shared-memory loads per 16 FMA,
// then reduced against KV; both output dims' W (transposed by the wrapper,
// so a tile row is contiguous) are loaded once per block (16-byte copies
// where n is a multiple of 4) and stay in shared memory for the whole
// launch where they fit (64 KB: n <= 89 in f32, 64 in f64), else they
// stream through shared memory in 16-deep slices per row tile. Every
// thread carries its own lane's tube algebra (the threads of a lane hold
// the same values; one writes) and keeps its lane's GP inputs in
// registers, so the 2x2 algebra, the margins and the costs run on all
// eight warps between two barriers per output dim and stage. Nothing but
// cost and viol leaves the chip; ragged lanes are masked in the kernel.
// IEEE FMA on the CUDA cores, no tensor cores, no TF32.

#include "gemm_tile.cuh"
#include "gp_lanes.cuh"

namespace {

using gpl::DMAX;
using gpl::maxnan;

constexpr int NT = 256;            // threads per block
constexpr int KS = 16;             // depth slice of the streamed W
constexpr size_t RESIDENT_MAX = 64 * 1024;  // bytes of W kept resident
constexpr unsigned ALL = 0xffffffffu;

// Offsets into the constant block (prepare_tube_score in cem_score.py): the
// plant's constants first (one host-to-device copy), then the model's.
struct Cst {
  int a, b, kfb, bmat, tgt, hom, hov, hsm, hsv, lmu, lsig, noise, sf2, flr,
      ils, ils2, total;
  __host__ __device__ Cst(int n_u, int n_obs, int n_sr) {
    const int d = 2 + n_u;
    a = 0;
    b = a + 4;
    kfb = b + 2 * n_u;
    bmat = kfb + 2 * n_u;
    tgt = bmat + 4;
    hom = tgt + 2;
    hov = hom + 2 * n_obs;
    hsm = hov + n_obs;
    hsv = hsm + 2 * n_sr;
    lmu = hsv + n_sr;
    lsig = lmu + 2;
    noise = lsig + 2;
    sf2 = noise + 2;
    flr = sf2 + 2;
    ils = flr + 2;
    ils2 = ils + 2 * d;
    total = ils2 + 2 * d;
  }
};

// viol += sum_i max(h_i . p + sqrt(max(h_i Q h_i, 0)) - hv_i, 0)
template <typename T>
__device__ T margins(const T* hm, const T* hv, int rows, T p[2], T q[2][2],
                     T viol) {
  for (int i = 0; i < rows; ++i) {
    T lin = T(0), sup = T(0);
    for (int j = 0; j < 2; ++j) {
      lin += hm[2 * i + j] * p[j];
      for (int k = 0; k < 2; ++k) sup += hm[2 * i + j] * q[j][k] * hm[2 * i + k];
    }
    const T gm = lin + gpl::sqrt_(maxnan(sup, T(0))) - hv[i];
    viol += maxnan(gm, T(0));
  }
  return viol;
}

// q <- (1 + 1/c) q + (1 + c) diag(2 hw^2), c = sqrt(tr q / tr diag) (floors 1e-30)
template <typename T>
__device__ void diag_sum(T q[2][2], const T hw[2]) {
  const T eps = T(1e-30);
  const T t1 = q[0][0] + q[1][1] + eps;
  const T t2 = T(2) * hw[0] * hw[0] + T(2) * hw[1] * hw[1] + eps;
  const T c = gpl::sqrt_(t1 / t2);
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) q[i][j] = (T(1) + T(1) / c) * q[i][j];
  for (int i = 0; i < 2; ++i) q[i][i] = q[i][i] + (T(1) + c) * T(2) * hw[i] * hw[i];
}

__host__ __device__ inline int pad4(int n) { return (n + 3) / 4 * 4; }

// Shared memory of a block, in elements: kv (n x LB), W (resident: 2 x n x
// pad4(n); streamed: one KS x RT slice), the per-warp partial quadratic
// forms (NT / 32 x LB), the mean and Jacobian rows (1 + DMAX) x LB, the support
// rows x (n x d), x / ls (2 x n x d) and w_mean (2 x n). The arrays read
// with vector loads come first, each a multiple of 4 elements long.
__host__ inline size_t smem_elems(int n, int d, bool resident, int lb) {
  const int rt = 4 * (NT / (lb / 4));
  return (size_t)n * lb + (resident ? 2 * (size_t)n * pad4(n) : KS * rt) +
         (NT / 32) * lb + (1 + DMAX) * lb + 3 * (size_t)n * d + 2 * n;
}

// f32: two blocks per SM (at most 128 registers a thread)
template <typename T, int LB>
__global__ void __launch_bounds__(NT, sizeof(T) == 4 ? 2 : 1)
cem_score_kernel(const T* __restrict__ x, const T* __restrict__ xil,
                 const T* __restrict__ wm, const T* __restrict__ wvt,
                 const T* __restrict__ cst, const T* __restrict__ u,
                 const T* __restrict__ x0, T* __restrict__ cost_out,
                 T* __restrict__ viol_out, int n, int n_u, int L, int t_len,
                 int n_obs, int n_sr, int resident, T c_safety, int explore,
                 T w_x, T w_u, T w_t, T scale) {
  constexpr int TX = LB / 4;       // lane groups of 4 in the product tile
  constexpr int TY = NT / TX;      // row groups of 4
  constexpr int RT = 4 * TY;       // rows of a product tile
  constexpr int G = NT / LB;       // threads per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = 2 + n_u, np = pad4(n);
  T* kv = reinterpret_cast<T*>(smem_raw);
  T* wsh = kv + (size_t)n * LB;
  T* red = wsh + (resident ? 2 * (size_t)n * np : KS * RT);
  T* aug = red + (NT / 32) * LB;
  T* xs = aug + (1 + DMAX) * LB;
  T* xl = xs + (size_t)n * d;
  T* wms = xl + 2 * (size_t)n * d;

  const int tid = threadIdx.x;
  const int l = tid % LB, g = tid / LB;   // lane of the GP and the algebra
  const int tx = tid % TX, ty = tid / TX; // place in the product tile
  const int lane = blockIdx.x * LB + l;
  const bool live = lane < L;
  const Cst o(n_u, n_obs, n_sr);

  for (int idx = tid; idx < n * d; idx += NT) xs[idx] = x[idx];
  for (int idx = tid; idx < 2 * n * d; idx += NT) xl[idx] = xil[idx];
  for (int idx = tid; idx < 2 * n; idx += NT) wms[idx] = wm[idx];
  if (resident && np == n) {
    // 16-byte copies, all of a thread's in flight: W is 2 n^2 contiguous
    const int4* src = reinterpret_cast<const int4*>(wvt);
    int4* dst = reinterpret_cast<int4*>(wsh);
    const int n16 = 2 * n * n * (int)sizeof(T) / 16;
#pragma unroll 8
    for (int idx = tid; idx < n16; idx += NT) dst[idx] = src[idx];
  } else if (resident) {
    for (int idx = tid; idx < 2 * n * np; idx += NT) {
      const int ek = idx / np, r = idx % np;
      wsh[idx] = r < n ? wvt[(size_t)ek * n + r] : T(0);
    }
  }
  __syncthreads();

  T z[DMAX];   // the lane's GP input (p, u_t)
  z[0] = live ? x0[lane] : T(0);
  z[1] = live ? x0[(size_t)L + lane] : T(0);
#pragma unroll
  for (int k = 0; k < DMAX - 2; ++k) {
    z[2 + k] = live && k < n_u ? u[(size_t)k * L + lane] : T(0);
  }
  T p[2], q[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
  T viol = T(0), stage_cost = T(0), expl = T(0), ctrl = T(0);

  for (int t = 0; t < t_len; ++t) {
    T mu[2], var[2], jac[2][DMAX];
    for (int e = 0; e < 2; ++e) {
      const T* ils = cst + o.ils + e * d;
      const T sf2 = cst[o.sf2 + e];
      // 1. kv_i = sf2 exp(-|x_i / ls - z / ls|^2 / 2) of the block's lanes
      {
        T zil[DMAX];
#pragma unroll
        for (int j = 0; j < DMAX; ++j) zil[j] = j < d ? z[j] * ils[j] : T(0);
        const T* xe = xl + (size_t)e * n * d;
        for (int i = g; i < n; i += G) {
          T d2 = T(0);
#pragma unroll
          for (int j = 0; j < DMAX; ++j) {
            if (j >= d) break;
            const T df = xe[i * d + j] - zil[j];
            d2 += df * df;
          }
          kv[i * LB + l] = sf2 * gpl::exp_(T(-0.5) * d2);
        }
      }
      __syncthreads();
      // 2. the mean and, past stage 0, the Jacobian's rows
      //    sum_i x_ij kv_i w_i, one (row, lane) per thread
      const T* we = wms + (size_t)e * n;
      for (int r = g; r < (t > 0 ? 1 + d : 1); r += G) {
        T acc = T(0);
        if (r == 0) {
          for (int i = 0; i < n; ++i) acc += we[i] * kv[i * LB + l];
        } else {
          for (int i = 0; i < n; ++i) acc += xs[i * d + r - 1] * (kv[i * LB + l] * we[i]);
        }
        aug[r * LB + l] = acc;
      }
      // 3. quad = kv^T W kv: V = W KV in RT x LB tiles, 4 x 4 per thread
      T qp[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) qp[w] = T(0);
      for (int r0 = 0; r0 < np; r0 += RT) {
        const int rr = r0 + 4 * ty;   // this thread's first row
        T acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[i][w] = T(0);
        auto step = [&](const T* wrow, const T* kvrow) {
          T wv[4], kr[4];
          lds4(wv, wrow);
          lds4(kr, kvrow + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int w = 0; w < 4; ++w) acc[i][w] += wv[i] * kr[w];
          }
        };
        if (resident) {
          if (rr < np) {
            const T* w0 = wsh + (size_t)e * n * np + rr;
            for (int k = 0; k < n; ++k) step(w0 + (size_t)k * np, kv + k * LB);
          }
        } else {
          const T* we_t = wvt + (size_t)e * n * n;
          for (int k0 = 0; k0 < n; k0 += KS) {
            for (int idx = tid; idx < KS * RT; idx += NT) {
              const int kk = idx / RT, r = r0 + idx % RT;
              wsh[idx] = (k0 + kk < n && r < n)
                             ? we_t[(size_t)(k0 + kk) * n + r] : T(0);
            }
            __syncthreads();
            const int kn = min(KS, n - k0);
            if (rr < np) {
              for (int kk = 0; kk < kn; ++kk) {
                step(wsh + kk * RT + 4 * ty, kv + (k0 + kk) * LB);
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
          for (int w = 0; w < 4; ++w) qp[w] += kr[w] * acc[i][w];
        }
      }
      // the row groups of a warp share their lanes: sum them by shuffles,
      // one partial per warp and lane to shared memory
#pragma unroll
      for (int off = TX; off < 32; off *= 2) {
#pragma unroll
        for (int w = 0; w < 4; ++w) qp[w] += __shfl_xor_sync(ALL, qp[w], off);
      }
      if (tid % 32 < TX) {
#pragma unroll
        for (int w = 0; w < 4; ++w) red[(tid / 32) * LB + 4 * tx + w] = qp[w];
      }
      __syncthreads();
      // 4. every thread: its lane's mean, variance and Jacobian
      T quad = T(0);
      for (int h = 0; h < NT / 32; ++h) quad += red[h * LB + l];
      mu[e] = aug[l];
      var[e] = maxnan(sf2 - quad, cst[o.flr + e]);
      if (t > 0) {
#pragma unroll
        for (int j = 0; j < DMAX; ++j) {
          if (j >= d) break;
          jac[e][j] = (aug[(1 + j) * LB + l] - z[j] * mu[e]) * cst[o.ils2 + e * d + j];
        }
      }
    }

    const T* A = cst + o.a;
    const T* Bm = cst + o.b;
    const T* K = cst + o.kfb;
#pragma unroll
    for (int k = 0; k < DMAX - 2; ++k) {
      if (k >= n_u) break;
      ctrl += z[2 + k] * z[2 + k];
    }
    T pn[2];
    for (int i = 0; i < 2; ++i) {
      T acc = A[2 * i] * z[0] + A[2 * i + 1] * z[1];
      T bu = T(0);
#pragma unroll
      for (int k = 0; k < DMAX - 2; ++k) {
        if (k >= n_u) break;
        bu += Bm[n_u * i + k] * z[2 + k];
      }
      pn[i] = acc + bu + mu[i];
    }
    T hw_c[2];
    for (int i = 0; i < 2; ++i) hw_c[i] = c_safety * gpl::sqrt_(var[i] + cst[o.noise + i]);
    if (t == 0) {
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) q[i][j] = i == j ? T(2) * hw_c[i] * hw_c[i] : T(0);
    } else {
      // H = a + J_x + (b + J_u) k_fb
      T h[2][2];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) {
          T fb = T(0);
#pragma unroll
          for (int k = 0; k < DMAX - 2; ++k) {
            if (k >= n_u) break;
            fb += (Bm[n_u * i + k] + jac[i][2 + k]) * K[2 * k + j];
          }
          h[i][j] = A[2 * i + j] + jac[i][j] + fb;
        }
      T hq[2][2], ql[2][2];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) hq[i][j] = h[i][0] * q[0][j] + h[i][1] * q[1][j];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) ql[i][j] = hq[i][0] * h[j][0] + hq[i][1] * h[j][1];
      // Lipschitz remainder: r^2 = lambda_max(Q S^T S), closed form at n_s = 2
      const T* Bl = cst + o.bmat;
      T qb[2][2];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) qb[i][j] = q[i][0] * Bl[j] + q[i][1] * Bl[2 + j];
      const T tr = qb[0][0] + qb[1][1];
      const T det = qb[0][0] * qb[1][1] - qb[0][1] * qb[1][0];
      const T disc = gpl::sqrt_(maxnan(tr * tr - T(4) * det, T(0)));
      const T r_sqr = maxnan(T(0.5) * (tr + disc), T(0));
      const T r = gpl::sqrt_(r_sqr);
      T hw_t[2];
      for (int i = 0; i < 2; ++i) {
        hw_t[i] = T(0.5) * cst[o.lmu + i] * r_sqr;
        hw_c[i] = c_safety * (gpl::sqrt_(var[i] + cst[o.noise + i]) + cst[o.lsig + i] * r);
      }
      diag_sum(ql, hw_c);
      diag_sum(ql, hw_t);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) q[i][j] = ql[i][j];
    }
    for (int i = 0; i < 2; ++i) p[i] = pn[i];
    expl += gpl::sqrt_(var[0]) + gpl::sqrt_(var[1]);
    viol = margins(cst + o.hom, cst + o.hov, n_obs, p, q, viol);
    if (t < t_len - 1) {
      for (int i = 0; i < 2; ++i) {
        const T dx = p[i] - cst[o.tgt + i];
        stage_cost += dx * dx;
      }
      // the next stage's GP inputs (p, u_{t+1})
      z[0] = p[0];
      z[1] = p[1];
#pragma unroll
      for (int k = 0; k < DMAX - 2; ++k) {
        if (k >= n_u) break;
        z[2 + k] = live ? u[((size_t)(t + 1) * n_u + k) * L + lane] : T(0);
      }
    }
  }
  if (g != 0 || !live) return;
  viol = margins(cst + o.hsm, cst + o.hsv, n_sr, p, q, viol);
  T cost;
  if (explore) {
    cost = -scale * expl;
  } else {
    T term = T(0);
    for (int i = 0; i < 2; ++i) {
      const T dx = p[i] - cst[o.tgt + i];
      term += dx * dx;
    }
    cost = w_x * stage_cost + w_u * ctrl + w_t * term;
  }
  cost_out[lane] = cost;
  viol_out[lane] = viol;
}

template <typename T, int LB>
int launch_lb(const void* x, const void* xil, const void* wm, const void* wvt,
              const void* cst, const void* u, const void* x0, void* cost,
              void* viol, int n, int n_u, int L, int t_len, int n_obs,
              int n_sr, bool resident, size_t bytes, double c_safety,
              int explore, double w_x, double w_u, double w_t, double scale,
              cudaStream_t stream) {
  cudaError_t err = gpl::allow_smem(cem_score_kernel<T, LB>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (L + LB - 1) / LB;
  cem_score_kernel<T, LB><<<blocks, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(xil),
      static_cast<const T*>(wm), static_cast<const T*>(wvt),
      static_cast<const T*>(cst), static_cast<const T*>(u),
      static_cast<const T*>(x0), static_cast<T*>(cost), static_cast<T*>(viol),
      n, n_u, L, t_len, n_obs, n_sr, (int)resident, (T)c_safety, explore,
      (T)w_x, (T)w_u, (T)w_t, (T)scale);
  return (int)cudaGetLastError();
}

// 64 lanes a block where kv of 64 lanes fits in shared memory, else 32;
// W resident where both dims take at most RESIDENT_MAX bytes.
template <typename T>
int launch(const void* x, const void* xil, const void* wm, const void* wvt,
           const void* cst, const void* u, const void* x0, void* cost,
           void* viol, int n, int n_u, int L, int t_len, int n_obs, int n_sr,
           double c_safety, int explore, double w_x, double w_u, double w_t,
           double scale, cudaStream_t stream) {
  const int d = 2 + n_u;
  const bool resident = 2 * (size_t)n * pad4(n) * sizeof(T) <= RESIDENT_MAX;
  const size_t b64 = smem_elems(n, d, resident, 64) * sizeof(T);
  if (b64 <= gpl::SMEM_MAX) {
    return launch_lb<T, 64>(x, xil, wm, wvt, cst, u, x0, cost, viol, n, n_u, L,
                            t_len, n_obs, n_sr, resident, b64, c_safety,
                            explore, w_x, w_u, w_t, scale, stream);
  }
  const size_t b32 = smem_elems(n, d, resident, 32) * sizeof(T);
  return launch_lb<T, 32>(x, xil, wm, wvt, cst, u, x0, cost, viol, n, n_u, L,
                          t_len, n_obs, n_sr, resident, b32, c_safety, explore,
                          w_x, w_u, w_t, scale, stream);
}

}  // namespace

// x (n, 2 + n_u) support rows in raw coordinates, xil (2, n, 2 + n_u) the
// rows over each output dim's lengthscales, wm (2, n) and wvt (2, n, n) the
// masked posterior weights (w_var transposed), cst the constant block of
// cem_score.py (Cst(n_u, n_obs, n_sr).total values), u (t_len n_u, L)
// controls, x0 (2, L) initial states; out cost and viol (L,). Returns
// cudaGetLastError() (cudaErrorInvalidValue where the shared memory of one
// block cannot hold the model).
extern "C" int cem_score_lanes(const void* x, const void* xil, const void* wm,
                               const void* wvt, const void* cst,
                               const void* u, const void* x0, void* cost,
                               void* viol, int n, int n_u, int L, int t_len,
                               int n_obs, int n_sr, double c_safety,
                               int explore, double w_x, double w_u, double w_t,
                               double scale, int is_f64, void* stream) {
  if (n < 1 || n_u < 1 || 2 + n_u > DMAX || L < 1 || t_len < 1 ||
      n_obs < 0 || n_sr < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(x, xil, wm, wvt, cst, u, x0, cost, viol, n, n_u, L,
                          t_len, n_obs, n_sr, c_safety, explore, w_x, w_u, w_t,
                          scale, s);
  return launch<float>(x, xil, wm, wvt, cst, u, x0, cost, viol, n, n_u, L,
                       t_len, n_obs, n_sr, c_safety, explore, w_x, w_u, w_t,
                       scale, s);
}
