"""Static safe active learning: optimize the PROBE INPUT itself — port of
``safe_exploration_tpu/solvers/static_exploration.py``.

The static safe-learning NLP of the reference's exploration runner:

    max_{z=(x,u), k_ff}  sigma^2(z)
    s.t.   x inside the state polytope,
           the n_safe-step ellipsoid tube started at x under
           [u, k_ff_1..k_ff_{n-1}] stays inside the state polytope and its
           terminal ellipsoid lands in the safe (returnable) set,

solved by the exact-Hessian augmented-Lagrangian core
(:func:`~safe_exploration_tpu_torch.solvers.sqp.solve_al_nlp`), eagerly and
with no read-back inside a solve; a bank of warm starts is one batched
solve. :func:`polytope_box_bounds` also gives
the Lipschitz calibration its operating region.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from safe_exploration_tpu_torch.envs.base import Env
from safe_exploration_tpu_torch.reachability.onestep import (
    multistep_reachability,
)
from safe_exploration_tpu_torch.reachability.safety import (
    lin_ellipsoid_safety_distance,
)
from safe_exploration_tpu_torch.solvers.sqp import SqpConfig, solve_al_nlp

__all__ = ["StaticExplorationResult", "make_static_exploration_planner",
           "polytope_box_bounds", "static_warm_len"]


def polytope_box_bounds(h_mat, h_vec, fallback: float = 10.0):
    """Per-dimension box bounds (lo, hi) as numpy arrays, implied by the
    axis-aligned rows of the polytope {x : H x <= h}; a dimension no such row
    bounds gets +-``fallback``. Accepts tensors or arrays."""
    h_mat = np.asarray(h_mat.cpu() if hasattr(h_mat, "cpu") else h_mat)
    h_vec = np.asarray(h_vec.cpu() if hasattr(h_vec, "cpu") else h_vec)
    n = h_mat.shape[1]
    lo = np.full((n,), -fallback)
    hi = np.full((n,), fallback)
    for r in range(h_mat.shape[0]):
        nz = np.nonzero(np.abs(h_mat[r]) > 1e-12)[0]
        if len(nz) != 1:
            continue
        i, c = int(nz[0]), h_mat[r, nz[0]]
        bound = h_vec[r] / c
        if c > 0:
            hi[i] = min(hi[i], bound)
        else:
            lo[i] = max(lo[i], bound)
    return lo, hi


class StaticExplorationResult(NamedTuple):
    """One solve's result; a bank's has the starts' axis in front."""

    x_probe: torch.Tensor      # (n_s,) chosen probe state
    u_probe: torch.Tensor      # (n_u,) chosen probe control
    k_ff_return: torch.Tensor  # (n_safe, n_u) tube controls, stage 0 u_probe
    feasible: torch.Tensor     # () bool: the probe is safely returnable
    violation: torch.Tensor    # () summed constraint violation
    sigma2: torch.Tensor       # (n_s,) predictive variance at the probe
    warm_next: torch.Tensor    # flat decision vector (next solve's warm start)


def static_warm_len(env: Env, cfg: SqpConfig) -> int:
    """Flat decision-vector length: [x_probe | u_probe | k_ff_return]."""
    spec = env.spec
    return spec.n_s + cfg.n_safe * spec.n_u


def make_static_exploration_planner(env: Env, k_fb: torch.Tensor,
                                    a: torch.Tensor, b: torch.Tensor,
                                    cfg: SqpConfig):
    """Build ``planner(ssm, warm_flat) -> StaticExplorationResult``.

    ``warm_flat`` (static_warm_len,) warm-starts the decision vector: zeros,
    the previous solve's ``warm_next``, or a random restart (the runner's
    restart bank; sampling the probe collapses sigma^2 there). A bank
    (R, static_warm_len) is solved in one batched solve (the JAX package
    vmaps the planner over it), every result field with R in front."""
    spec = env.spec
    n_s, n_u = spec.n_s, spec.n_u
    t_len = cfg.n_safe
    kw = {"dtype": a.dtype, "device": a.device}

    x_lo, x_hi = polytope_box_bounds(spec.h_mat_obs, spec.h_obs)
    lo = torch.cat([torch.as_tensor(x_lo, **kw), spec.u_min.repeat(t_len)])
    hi = torch.cat([torch.as_tensor(x_hi, **kw), spec.u_max.repeat(t_len)])
    k_fb_all = k_fb.expand(t_len, *k_fb.shape)

    def split(v):
        """(..., n_flat) -> x_probe (..., n_s), k_ff_all (..., T, n_u)."""
        return v[..., :n_s], v[..., n_s:].reshape(v.shape[:-1] + (t_len, n_u))

    def planner(ssm, warm_flat: torch.Tensor) -> StaticExplorationResult:
        noise_var = ssm.noise_var()

        def objective(v):
            x_probe, k_ff_all = split(v)
            _, var = ssm.predict_latent(torch.cat([x_probe, k_ff_all[0]]))
            # negative exact information gain (better conditioned than raw
            # sigma^2; the same argmax direction)
            return -0.5 * torch.sum(torch.log1p(var / noise_var))

        def constraints(v):
            # v (..., n_flat): the polish's folded copies come batched
            x_probe, k_ff_all = split(v)
            # the probe state itself must be safe
            d_probe = x_probe @ spec.h_mat_obs.T - spec.h_obs
            # and the tube from it must stay safe and RETURN to the safe set
            p_traj, q_traj, _ = multistep_reachability(
                ssm, x_probe, k_ff_all, k_fb_all, a, b, cfg.c_safety)
            d_stage = lin_ellipsoid_safety_distance(
                p_traj, q_traj, spec.h_mat_obs, spec.h_obs)
            d_term = lin_ellipsoid_safety_distance(
                p_traj[..., -1, :], q_traj[..., -1, :, :], spec.h_mat_safe,
                spec.h_safe)
            return torch.cat([d_probe, d_stage.flatten(-2), d_term], dim=-1)

        v_fin, _, g_fin = solve_al_nlp(objective, constraints, warm_flat, lo,
                                       hi, cfg)
        violation = torch.sum(torch.clamp(g_fin, min=0.0), dim=-1)
        x_probe, k_ff_all = split(v_fin)
        u_probe = k_ff_all[..., 0, :]
        _, sigma2 = ssm.predict_latent(torch.cat([x_probe, u_probe], dim=-1))
        return StaticExplorationResult(
            x_probe=x_probe, u_probe=u_probe, k_ff_return=k_ff_all,
            feasible=violation <= cfg.feas_tol, violation=violation,
            sigma2=sigma2, warm_next=v_fin)

    return planner
