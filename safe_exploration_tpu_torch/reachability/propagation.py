"""Performance-trajectory uncertainty propagation — port of
``safe_exploration_tpu/reachability/propagation.py``.

The performance trajectory of the safe-MPC carries the objective and uses
cheap Gaussian moment propagation instead of the guaranteed ellipsoid
over-approximation, open loop (no feedback term):

  * ``mean_equivalent``: propagate the mean, accumulate the GP variance
    additively: Sigma+ = Sigma + diag(var + noise);
  * ``taylor``: first order, Sigma+ = H Sigma H^T + diag(var + noise) with
    H = a + J_mu,x (+ (b + J_mu,u) k_fb when a gain is given).

Every function takes leading batch dimensions (p (..., n_s), Sigma
(..., n_s, n_s), u (..., n_u)); the horizon fold is a Python loop.
"""

from __future__ import annotations

import torch

from safe_exploration_tpu_torch.models.ssm import (
    GPSSM,
    ssm_noise_var,
    ssm_predict,
    ssm_predict_jac,
)

__all__ = ["one_step_mean_equivalent", "one_step_taylor",
           "multi_step_propagation"]


def _add_diag(sigma, d):
    return sigma + torch.diag_embed(d)


def one_step_mean_equivalent(ssm: GPSSM, p, sigma, u, a, b):
    """Sigma+ = Sigma + diag(var + noise). Returns (p_next, sigma_next,
    var)."""
    mu, var = ssm_predict(ssm, p, u)
    p_next = p @ a.T + u @ b.T + mu
    return p_next, _add_diag(sigma, var + ssm_noise_var(ssm)), var


def one_step_taylor(ssm: GPSSM, p, sigma, u, a, b, k_fb=None):
    """Sigma+ = H Sigma H^T + diag(var + noise), H = a + J_mu,x
    (+ (b + J_mu,u) k_fb). Returns (p_next, sigma_next, var)."""
    mu, var, j_x, j_u = ssm_predict_jac(ssm, p, u)
    p_next = p @ a.T + u @ b.T + mu
    h = a + j_x
    if k_fb is not None:
        h = h + (b + j_u) @ k_fb
    sigma_next = h @ sigma @ h.transpose(-1, -2)
    return p_next, _add_diag(sigma_next, var + ssm_noise_var(ssm)), var


def multi_step_propagation(ssm: GPSSM, p0, u_all, a, b, *,
                           method: str = "taylor", k_fb=None):
    """Propagate the performance trajectory from p0 (..., n_s) under the
    controls u_all (..., T, n_u). Returns (p_traj (..., T, n_s), sigma_traj
    (..., T, n_s, n_s), var_traj (..., T, n_s)); stage t is the state after
    t + 1 steps."""
    if method == "mean_equivalent":
        def step(p, s, u):
            return one_step_mean_equivalent(ssm, p, s, u, a, b)
    elif method == "taylor":
        def step(p, s, u):
            return one_step_taylor(ssm, p, s, u, a, b, k_fb)
    else:
        raise ValueError(f"unknown perf_trajectory method: {method}")
    n_s = p0.shape[-1]
    p = p0
    s = torch.zeros(p0.shape[:-1] + (n_s, n_s), dtype=p0.dtype,
                    device=p0.device)
    ps, ss, vs = [], [], []
    for t in range(u_all.shape[-2]):
        p, s, var = step(p, s, u_all[..., t, :])
        ps.append(p)
        ss.append(s)
        vs.append(var)
    return (torch.stack(ps, dim=-2), torch.stack(ss, dim=-3),
            torch.stack(vs, dim=-2))
