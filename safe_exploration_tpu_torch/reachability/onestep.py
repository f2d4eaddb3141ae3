"""Ellipsoidal reachability of GP dynamics — port of
``safe_exploration_tpu/reachability/onestep.py``.

One step of the closed loop x+ = a x + b u + GP(x, u), u = k_ff + k_fb
(x - p), from the ellipsoid E(p, Q):

  1. GP mean, variance and mean Jacobians at the center z = (p, k_ff);
  2. next center  p+ = a p + b k_ff + mu(z);
  3. affine part  H = a + J_mu,x + (b + J_mu,u) k_fb,  Q_lin = H Q H^T;
  4. Lipschitz remainder boxes -> the Taylor-error ellipsoid;
  5. confidence box c_safety (sqrt(var + noise) + u_sigma) -> the
     uncertainty ellipsoid;
  6. the trace-minimal Minkowski sum of the three.

Every function takes leading batch dimensions on the state, shape and
control (p (..., n_s), Q (..., n_s, n_s), k_ff (..., n_u)); the horizon
fold is a Python loop. A stacked model (L lanes, ``models/ssm.py``) takes
points whose first axis is its lane axis, (L, ..., n_s): each lane's tubes
under its own model and constants (JAX's ``vmap`` over models).
"""

from __future__ import annotations

import torch

from safe_exploration_tpu_torch.models.ssm import (
    GPSSM,
    lane_front,
    ssm_noise_var,
    ssm_predict,
    ssm_predict_jac,
)
from safe_exploration_tpu_torch.ops.ellipsoid import (
    ellipsoid_from_rectangle,
    sum_two_ellipsoids,
)
from safe_exploration_tpu_torch.ops.lipschitz import (
    compute_remainder_overapproximations,
)

__all__ = ["onestep_reachability_point", "onestep_reachability",
           "multistep_reachability"]


def onestep_reachability_point(ssm: GPSSM, p, k_ff, a, b, c_safety):
    """Reachable ellipsoid after one step from a point state: returns
    (p_next (..., n_s), q_next (..., n_s, n_s), var (..., n_s))."""
    mu, var = ssm_predict(ssm, p, k_ff)
    p_next = p @ a.T + k_ff @ b.T + mu
    q_next = ellipsoid_from_rectangle(
        c_safety * torch.sqrt(var + lane_front(ssm, ssm_noise_var(ssm), p)))
    return p_next, q_next, var


def onestep_reachability(ssm: GPSSM, p, q, k_ff, k_fb, a, b, c_safety):
    """Reachable ellipsoid after one closed-loop step from E(p, Q) under
    u = k_ff + k_fb (x - p): returns (p_next, q_next, var)."""
    mu, var, j_x, j_u = ssm_predict_jac(ssm, p, k_ff)
    p_next = p @ a.T + k_ff @ b.T + mu
    h = a + j_x + (b + j_u) @ k_fb
    q_lin = h @ q @ h.transpose(-1, -2)
    u_mu, u_sigma = compute_remainder_overapproximations(
        q, k_fb, lane_front(ssm, ssm.l_mu, p),
        lane_front(ssm, ssm.l_sigma, p))
    q_taylor = ellipsoid_from_rectangle(u_mu)
    q_conf = ellipsoid_from_rectangle(
        c_safety * (torch.sqrt(var + lane_front(ssm, ssm_noise_var(ssm), p))
                    + u_sigma))
    zero = torch.zeros_like(p_next)
    p_sum, q_sum = sum_two_ellipsoids(p_next, q_lin, zero, q_conf)
    p_out, q_out = sum_two_ellipsoids(p_sum, q_sum, zero, q_taylor)
    return p_out, q_out, var


def multistep_reachability(ssm: GPSSM, p0, k_ff_all, k_fb_all, a, b,
                           c_safety, q0=None):
    """Fold the one-step map over the horizon with per-stage controls
    k_ff_all (..., T, n_u) and gains k_fb_all (..., T, n_u, n_s) (leading
    dims optional; stage 0's gain is unused from a point). Returns
    (p_traj (..., T, n_s), q_traj (..., T, n_s, n_s), var_traj
    (..., T, n_s)); stage t is the state after t + 1 steps."""
    if q0 is None:
        p, q, var = onestep_reachability_point(
            ssm, p0, k_ff_all[..., 0, :], a, b, c_safety)
    else:
        p, q, var = onestep_reachability(
            ssm, p0, q0, k_ff_all[..., 0, :], k_fb_all[..., 0, :, :], a, b,
            c_safety)
    ps, qs, vs = [p], [q], [var]
    for t in range(1, k_ff_all.shape[-2]):
        p, q, var = onestep_reachability(
            ssm, p, q, k_ff_all[..., t, :], k_fb_all[..., t, :, :], a, b,
            c_safety)
        ps.append(p)
        qs.append(q)
        vs.append(var)
    return (torch.stack(ps, dim=-2), torch.stack(qs, dim=-3),
            torch.stack(vs, dim=-2))
