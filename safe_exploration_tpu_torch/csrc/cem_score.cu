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
// posterior for both output dims, 2 n^2 flops each for the variance, about
// 1.3 GFLOP at the lane CEM's 16,384 lanes and n = 64, against 4 bytes in and
// out per lane and step. What the design does about it: the posterior is the
// block-level one of gp_lanes.cuh (kv in shared memory, w_var streamed in
// 16-row tiles, four warps splitting the rows); the 2x2 tube algebra, the
// margins and the costs stay in registers of warp 0, one lane per thread,
// which also writes the next stage's GP inputs to shared memory. Nothing but
// cost and viol leaves the chip. Ragged lanes are masked in the kernel.

#include "gp_lanes.cuh"

namespace {

// Offsets into the constant block (see tube_score_lanes in cem_score.py).
struct Cst {
  int a, b, kfb, bmat, lmu, lsig, noise, sf2, flr, ils, ils2, tgt, hom, hov,
      hsm, hsv, total;
  __host__ __device__ Cst(int n_u, int n_obs, int n_sr) {
    const int d = 2 + n_u;
    a = 0;
    b = a + 4;
    kfb = b + 2 * n_u;
    bmat = kfb + 2 * n_u;
    lmu = bmat + 4;
    lsig = lmu + 2;
    noise = lsig + 2;
    sf2 = noise + 2;
    flr = sf2 + 2;
    ils = flr + 2;
    ils2 = ils + 2 * d;
    tgt = ils2 + 2 * d;
    hom = tgt + 2;
    hov = hom + 2 * n_obs;
    hsm = hov + n_obs;
    hsv = hsm + 2 * n_sr;
    total = hsv + n_sr;
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
    const T gm = lin + gpl::sqrt_(gpl::maxnan(sup, T(0))) - hv[i];
    viol += gpl::maxnan(gm, T(0));
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

template <typename T>
__global__ void __launch_bounds__(gpl::NT)
cem_score_kernel(const T* __restrict__ x, const T* __restrict__ wm,
                 const T* __restrict__ wv, const T* __restrict__ cst,
                 const T* __restrict__ u, const T* __restrict__ x0,
                 T* __restrict__ cost_out, T* __restrict__ viol_out, int n,
                 int n_u, int L, int t_len, int n_obs, int n_sr, T c_safety,
                 int explore, T w_x, T w_u, T w_t, T scale) {
  using namespace gpl;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = 2 + n_u;
  const Smem<T> sm = carve(reinterpret_cast<T*>(smem_raw), n, d);
  const Cst o(n_u, n_obs, n_sr);
  const int l = threadIdx.x % LB, g = threadIdx.x / LB;
  const int lane = blockIdx.x * LB + l;
  const bool live = lane < L;
  load_rows(sm, x, n, d);

  T p[2], q[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
  T viol = T(0), stage_cost = T(0), expl = T(0), ctrl = T(0);
  if (g == 0) {
    for (int i = 0; i < 2; ++i) sm.zb[i * LB + l] = live ? x0[(size_t)i * L + lane] : T(0);
    for (int k = 0; k < n_u; ++k)
      sm.zb[(2 + k) * LB + l] = live ? u[(size_t)k * L + lane] : T(0);
  }
  for (int t = 0; t < t_len; ++t) {
    T mu[2], var[2], jac[2][DMAX];
    for (int e = 0; e < 2; ++e) {
      T m, quad, s, rows[DMAX];
      posterior_dim(sm, wm + (size_t)e * n, wv + (size_t)e * n * n,
                    cst + o.ils + e * d, cst[o.sf2 + e], n, d, t > 0, m, quad,
                    s, rows);
      if (g == 0) {
        mu[e] = m;
        var[e] = maxnan(cst[o.sf2 + e] - quad, cst[o.flr + e]);
        if (t > 0)
          for (int j = 0; j < d; ++j)
            jac[e][j] = (rows[j] - sm.zb[j * LB + l] * s) * cst[o.ils2 + e * d + j];
      }
    }
    if (g != 0) continue;  // warp 0 carries the tube; the others only help the GP

    const T* A = cst + o.a;
    const T* Bm = cst + o.b;
    const T* K = cst + o.kfb;
    T pz[2], kff[DMAX];
    for (int i = 0; i < 2; ++i) pz[i] = sm.zb[i * LB + l];
    for (int k = 0; k < n_u; ++k) {
      kff[k] = sm.zb[(2 + k) * LB + l];
      ctrl += kff[k] * kff[k];
    }
    T pn[2];
    for (int i = 0; i < 2; ++i) {
      T acc = A[2 * i] * pz[0] + A[2 * i + 1] * pz[1];
      T bu = T(0);
      for (int k = 0; k < n_u; ++k) bu += Bm[n_u * i + k] * kff[k];
      pn[i] = acc + bu + mu[i];
    }
    T hw_c[2];
    for (int i = 0; i < 2; ++i) hw_c[i] = c_safety * sqrt_(var[i] + cst[o.noise + i]);
    if (t == 0) {
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) q[i][j] = i == j ? T(2) * hw_c[i] * hw_c[i] : T(0);
    } else {
      // H = a + J_x + (b + J_u) k_fb
      T h[2][2];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) {
          T fb = T(0);
          for (int k = 0; k < n_u; ++k) fb += (Bm[n_u * i + k] + jac[i][2 + k]) * K[2 * k + j];
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
      const T disc = sqrt_(maxnan(tr * tr - T(4) * det, T(0)));
      const T r_sqr = maxnan(T(0.5) * (tr + disc), T(0));
      const T r = sqrt_(r_sqr);
      T hw_t[2];
      for (int i = 0; i < 2; ++i) {
        hw_t[i] = T(0.5) * cst[o.lmu + i] * r_sqr;
        hw_c[i] = c_safety * (sqrt_(var[i] + cst[o.noise + i]) + cst[o.lsig + i] * r);
      }
      diag_sum(ql, hw_c);
      diag_sum(ql, hw_t);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) q[i][j] = ql[i][j];
    }
    for (int i = 0; i < 2; ++i) p[i] = pn[i];
    expl += sqrt_(var[0]) + sqrt_(var[1]);
    viol = margins(cst + o.hom, cst + o.hov, n_obs, p, q, viol);
    if (t < t_len - 1) {
      for (int i = 0; i < 2; ++i) {
        const T dx = p[i] - cst[o.tgt + i];
        stage_cost += dx * dx;
      }
      // the next stage's GP inputs (p, u_{t+1})
      for (int i = 0; i < 2; ++i) sm.zb[i * LB + l] = p[i];
      for (int k = 0; k < n_u; ++k)
        sm.zb[(2 + k) * LB + l] =
            live ? u[((size_t)(t + 1) * n_u + k) * L + lane] : T(0);
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

template <typename T>
int launch(const void* x, const void* wm, const void* wv, const void* cst,
           const void* u, const void* x0, void* cost, void* viol, int n,
           int n_u, int L, int t_len, int n_obs, int n_sr, double c_safety,
           int explore, double w_x, double w_u, double w_t, double scale,
           cudaStream_t stream) {
  const size_t bytes = gpl::smem_bytes(n, 2 + n_u, sizeof(T));
  cudaError_t err = gpl::allow_smem(cem_score_kernel<T>, bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (L + gpl::LB - 1) / gpl::LB;
  cem_score_kernel<T><<<blocks, gpl::NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wm),
      static_cast<const T*>(wv), static_cast<const T*>(cst),
      static_cast<const T*>(u), static_cast<const T*>(x0),
      static_cast<T*>(cost), static_cast<T*>(viol), n, n_u, L, t_len, n_obs,
      n_sr, (T)c_safety, explore, (T)w_x, (T)w_u, (T)w_t, (T)scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, 2 + n_u) support rows in raw coordinates, wm (2, n), wv (2, n, n)
// masked posterior weights, cst the constant block of cem_score.py
// (Cst(n_u, n_obs, n_sr).total values), u (t_len n_u, L) controls, x0 (2, L)
// initial states; out cost and viol (L,). Returns cudaGetLastError().
extern "C" int cem_score_lanes(const void* x, const void* wm, const void* wv,
                               const void* cst, const void* u, const void* x0,
                               void* cost, void* viol, int n, int n_u, int L,
                               int t_len, int n_obs, int n_sr, double c_safety,
                               int explore, double w_x, double w_u, double w_t,
                               double scale, int is_f64, void* stream) {
  if (n < 1 || n_u < 1 || 2 + n_u > gpl::DMAX || L < 1 || t_len < 1 ||
      n_obs < 0 || n_sr < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f64)
    return launch<double>(x, wm, wv, cst, u, x0, cost, viol, n, n_u, L, t_len,
                          n_obs, n_sr, c_safety, explore, w_x, w_u, w_t, scale,
                          s);
  return launch<float>(x, wm, wv, cst, u, x0, cost, viol, n, n_u, L, t_len,
                       n_obs, n_sr, c_safety, explore, w_x, w_u, w_t, scale, s);
}
