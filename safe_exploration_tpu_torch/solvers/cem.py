"""Constrained cross-entropy-method safe-MPC planner — port of
``safe_exploration_tpu/solvers/cem.py``.

Sample M control sequences from per-stage Gaussians, roll out their
ellipsoid tubes, score cost + penalty * violation, refit the sampling
distribution from the elites, iterate; return the best sequence seen. The
JAX package ``vmap``s the tube over the samples; here the reachability
functions take the sample dimension as a leading batch dimension, and only
the user's scalar cost function is vectorized with ``torch.func.vmap``.

With ``n_perf > 0`` the objective rides an ``n_perf``-step Gaussian
propagation (``reachability/propagation.multi_step_propagation``) over
u_perf_all = [k_ff[:r], the free perf controls], while violations stay on
the safety tube — the joint safety + performance structure of the JAX
package.

``jax.random`` keys become a ``torch.Generator`` (``None``: a fresh one
seeded 0 on the planner's device, as the JAX package uses PRNGKey(0)) or
an explicit ``noise`` tensor of the per-iteration standard-normal draws.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from safe_exploration_tpu_torch.reachability.onestep import (
    multistep_reachability,
)
from safe_exploration_tpu_torch.reachability.propagation import (
    multi_step_propagation,
)
from safe_exploration_tpu_torch.reachability.safety import (
    lin_ellipsoid_safety_distance,
)

__all__ = ["CemConfig", "cem_plan", "cem_warm_len", "tube_violation",
           "draw_noise"]

# cost_fn(p_traj, q_traj, var_traj, k_ff_all) -> scalar (lower is better)
CostFn = Callable[..., torch.Tensor]


class CemConfig(NamedTuple):
    """Static CEM hyperparameters (the JAX package's fields and defaults)."""

    n_safe: int = 5            # safety horizon T
    n_samples: int = 256       # M sequences per iteration
    n_elites: int = 32
    n_iterations: int = 8
    init_std: float = 0.4      # initial sampling std (fraction of control range)
    min_std: float = 1e-3      # std floor
    penalty: float = 1e3       # constraint-violation penalty weight
    smoothing: float = 0.3     # distribution update smoothing (0 = replace)
    feas_tol: float = 1e-4     # feasibility gate on the summed violation
    n_perf: int = 0            # performance horizon (0 = none)
    r_shared: int = 1
    # posterior / scorer of the lane CEM (solvers/cem_lanes.py); the
    # portable planner ignores it
    gp_impl: str = "auto"
    perf_method: str = "taylor"


def cem_warm_len(cfg: CemConfig) -> int:
    """Rows of the planner's decision / warm-start matrix."""
    if cfg.n_perf <= 0:
        return cfg.n_safe
    r = min(cfg.r_shared, cfg.n_safe, cfg.n_perf)
    return cfg.n_safe + (cfg.n_perf - r)


def draw_noise(generator: torch.Generator | None, shape: tuple, dtype,
               device) -> torch.Tensor:
    """Standard-normal draws from ``generator`` (``None``: a fresh generator
    seeded 0 on ``device``), drawn on the generator's device and moved to
    ``device``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    z = torch.randn(shape, generator=generator, dtype=dtype,
                    device=generator.device)
    return z.to(device)


def tube_violation(p_traj, q_traj, h_mat_obs, h_obs, h_mat_safe, h_safe):
    """Total positive constraint violation of tubes p (..., T, n_s), Q
    (..., T, n_s, n_s): the state polytope on every stage plus the terminal
    safe polytope on the last; 0 iff feasible."""
    d_stage = lin_ellipsoid_safety_distance(p_traj, q_traj, h_mat_obs, h_obs)
    d_term = lin_ellipsoid_safety_distance(p_traj[..., -1, :],
                                           q_traj[..., -1, :, :], h_mat_safe,
                                           h_safe)
    return (torch.clamp(d_stage, min=0.0).sum((-2, -1))
            + torch.clamp(d_term, min=0.0).sum(-1))


def cem_plan(generator, ssm, x0, k_fb, a, b, u_min, u_max, h_mat_obs, h_obs,
             h_mat_safe, h_safe, c_safety: float, cost_fn: CostFn,
             cfg: CemConfig, warm_mean=None, noise=None):
    """Plan a safe feed-forward sequence from ``x0`` (n_s,).

    Returns (k_ff_all (n_safe, n_u), feasible, violation, info) with
    ``info = {cost, warm_next}`` (``warm_next`` the whole decision matrix,
    ``cem_warm_len(cfg)`` rows). ``noise`` (n_iterations, M, t_total, n_u)
    replaces the draws of ``generator``.
    """
    t_len, n_u = cfg.n_safe, u_min.shape[0]
    t_total = cem_warm_len(cfg)
    r = min(cfg.r_shared, t_len, cfg.n_perf) if cfg.n_perf > 0 else 0
    dtype, device = x0.dtype, x0.device
    u_range = (u_max - u_min) * 0.5
    mean0 = (torch.zeros((t_total, n_u), dtype=dtype, device=device)
             if warm_mean is None else warm_mean)
    std0 = cfg.init_std * torch.ones((t_total, n_u), dtype=dtype,
                                     device=device) * u_range
    k_fb_all = k_fb.expand(t_len, *k_fb.shape)
    batch_cost = torch.func.vmap(cost_fn)

    def score(seqs):
        """seqs (..., t_total, n_u) -> (score, viol, cost)."""
        k_ff_all = seqs[..., :t_len, :]
        p0 = x0.expand(*seqs.shape[:-2], x0.shape[-1])
        p, q, var = multistep_reachability(ssm, p0, k_ff_all, k_fb_all, a, b,
                                           c_safety)
        viol = tube_violation(p, q, h_mat_obs, h_obs, h_mat_safe, h_safe)
        u_cost = k_ff_all
        if cfg.n_perf > 0:
            u_cost = torch.cat([k_ff_all[..., :r, :], seqs[..., t_len:, :]],
                               dim=-2)
            p, q, var = multi_step_propagation(ssm, p0, u_cost, a, b,
                                               method=cfg.perf_method)
        if seqs.dim() == 2:
            cost = cost_fn(p, q, var, u_cost)
        else:
            cost = batch_cost(p, q, var, u_cost)
        return cost + cfg.penalty * viol, viol, cost

    if noise is None:
        noise = draw_noise(generator, (cfg.n_iterations, cfg.n_samples,
                                       t_total, n_u), dtype, device)
    else:
        noise = noise.to(dtype=dtype, device=device)
    mean, std, best_k = mean0, std0, mean0
    best_score = torch.tensor(float("inf"), dtype=dtype, device=device)
    for it in range(cfg.n_iterations):
        samples = torch.clamp(mean + std * noise[it], u_min, u_max)
        samples[0] = torch.clamp(mean, u_min, u_max)   # elite retention
        scores, _, _ = score(samples)
        # lax.top_k(-scores, k): the k smallest, ties to the lower index
        elites = samples[torch.argsort(scores, stable=True)[:cfg.n_elites]]
        new_mean = torch.mean(elites, dim=0)
        new_std = torch.std(elites, dim=0, correction=0) + cfg.min_std
        mean = cfg.smoothing * mean + (1.0 - cfg.smoothing) * new_mean
        std = cfg.smoothing * std + (1.0 - cfg.smoothing) * new_std
        it_best = torch.argmin(scores)
        better = scores[it_best] < best_score
        best_k = torch.where(better, samples[it_best], best_k)
        best_score = torch.where(better, scores[it_best], best_score)

    mean_k = torch.clamp(mean, u_min, u_max)
    mean_score, _, _ = score(mean_k)
    seq_best = torch.where(mean_score <= best_score, mean_k, best_k)
    _, viol, cost = score(seq_best)
    return seq_best[:t_len], viol <= cfg.feas_tol, viol, {
        "cost": cost, "warm_next": seq_best}
