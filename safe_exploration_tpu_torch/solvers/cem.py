"""Constrained cross-entropy-method safe-MPC planner — port of
``safe_exploration_tpu/solvers/cem.py``.

Sample M control sequences from per-stage Gaussians, roll out their
ellipsoid tubes, score cost + penalty * violation, refit the sampling
distribution from the elites, iterate; return the best sequence seen. The
JAX package ``vmap``s the tube over the samples; here the reachability
functions take the sample dimension as a leading batch dimension, and only
the user's scalar cost function is vectorized with ``torch.func.vmap``.

The planner also runs B instances at once (the JAX package's ``vmap`` of
the planner over lanes, which its stacked fleet runner uses): a lane axis
in front of x0, the warm start and the draws, over one shared model or a
stacked model of one model per lane. Each lane keeps its own elites,
sampling distribution and best-ever archive. Its scores go through the
model-batched ``cem_score`` kernel where it covers the objective
(tracking or exploration at n_s 2 without a performance trajectory), else
through the reachability functions with the lane axis in front.

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

from safe_exploration_tpu_torch.models.ssm import ssm_predict
from safe_exploration_tpu_torch.ops.kernels import (
    cem_score_supported,
    prepare_tube_score,
    tube_score_prepared,
)
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
             cfg: CemConfig, warm_mean=None, noise=None, *,
             cost_kind: str | None = None, cost_args: dict | None = None):
    """Plan a safe feed-forward sequence from ``x0`` (n_s,), or for B
    instances at once from ``x0`` (B, n_s) (the JAX package's ``vmap`` of
    this planner, written out on a lane axis).

    Returns (k_ff_all (n_safe, n_u), feasible, violation, info) with
    ``info = {cost, warm_next, p_traj}`` (``warm_next`` the whole decision
    matrix, ``cem_warm_len(cfg)`` rows; ``p_traj`` (n_safe, n_s) the tube
    centres of the returned plan), each with the lane axis (B,) in front
    for a batched ``x0``. ``warm_mean`` (cem_warm_len(cfg), n_u) or (B,
    ...); ``noise`` (n_iterations, M, t_total, n_u), or (B, ...),
    replaces the draws of ``generator``.

    The model is one GP-SSM, or with a batched ``x0`` a stacked one whose
    lane b plans instance b. A batched solve whose objective the CEM
    scorer covers (``cost_kind`` and ``cost_args``: the objective's lane
    form; :func:`cem_score_supported`) scores every pass through
    ``tube_score_prepared`` (one launch per pass on CUDA, the model
    prepared once); otherwise, and for one instance, every score is
    :func:`multistep_reachability` with ``cost_fn``.
    """
    batched = x0.dim() == 2
    if not batched:
        x0 = x0[None]
        warm_mean = None if warm_mean is None else warm_mean[None]
        noise = None if noise is None else noise[None]
    t_len, n_u = cfg.n_safe, u_min.shape[0]
    t_total = cem_warm_len(cfg)
    bsz, n_s = x0.shape
    r = min(cfg.r_shared, t_len, cfg.n_perf) if cfg.n_perf > 0 else 0
    dtype, device = x0.dtype, x0.device
    u_range = (u_max - u_min) * 0.5
    mean0 = (torch.zeros((bsz, t_total, n_u), dtype=dtype, device=device)
             if warm_mean is None else warm_mean)
    std0 = cfg.init_std * torch.ones((bsz, t_total, n_u), dtype=dtype,
                                     device=device) * u_range
    k_fb_all = k_fb.expand(t_len, *k_fb.shape)
    batch_cost = torch.func.vmap(cost_fn)

    def score_tube(seqs):
        """seqs (B, m, t_total, n_u) -> (score, viol, cost (B, m), p_traj
        (B, m, n_safe, n_s)) through the reachability functions."""
        k_ff_all = seqs[..., :t_len, :]
        p0 = x0[:, None, :].expand(*seqs.shape[:-2], n_s)
        p_traj, q, var = multistep_reachability(ssm, p0, k_ff_all, k_fb_all,
                                                a, b, c_safety)
        viol = tube_violation(p_traj, q, h_mat_obs, h_obs, h_mat_safe,
                              h_safe)
        u_cost, p = k_ff_all, p_traj
        if cfg.n_perf > 0:
            u_cost = torch.cat([k_ff_all[..., :r, :], seqs[..., t_len:, :]],
                               dim=-2)
            p, q, var = multi_step_propagation(ssm, p0, u_cost, a, b,
                                               method=cfg.perf_method)
        lead = seqs.shape[:-2]
        cost = batch_cost(*(v.reshape(-1, *v.shape[len(lead):])
                            for v in (p, q, var, u_cost))).reshape(lead)
        return cost + cfg.penalty * viol, viol, cost, p_traj

    score = score_tube
    if (batched and cost_kind is not None
            and cem_score_supported(ssm, n_s, cost_kind, cfg.n_perf)):
        s_lift = torch.cat([torch.eye(n_s, dtype=dtype, device=device), k_fb])
        prep = prepare_tube_score(ssm, k_fb, a, b, s_lift.T @ s_lift,
                                  h_mat_obs, h_obs, h_mat_safe, h_safe,
                                  c_safety, t_len, cost_kind, cost_args)

        def score(seqs):
            """The scorer's lanes: model b's m sequences at columns
            b m ... b m + m - 1; no tube comes back."""
            m = seqs.shape[1]
            u_flat = seqs[..., :t_len, :].reshape(bsz * m, t_len * n_u).T
            x0_cols = x0.repeat_interleave(m, dim=0).T
            cost, viol = tube_score_prepared(prep, u_flat.contiguous(),
                                             x0_cols.contiguous())
            cost, viol = cost.reshape(bsz, m), viol.reshape(bsz, m)
            return cost + cfg.penalty * viol, viol, cost, None

    if noise is None:
        noise = draw_noise(generator, (bsz, cfg.n_iterations, cfg.n_samples,
                                       t_total, n_u), dtype, device)
    else:
        noise = noise.to(dtype=dtype, device=device)
    mean, std, best_k = mean0, std0, mean0
    best_score = torch.full((bsz,), float("inf"), dtype=dtype, device=device)
    for it in range(cfg.n_iterations):
        samples = torch.clamp(mean[:, None] + std[:, None] * noise[:, it],
                              u_min, u_max)
        samples[:, 0] = torch.clamp(mean, u_min, u_max)   # elite retention
        scores = score(samples)[0]
        # lax.top_k(-scores, k): the k smallest, ties to the lower index
        order = torch.argsort(scores, dim=1, stable=True)[:, :cfg.n_elites]
        elites = torch.take_along_dim(samples, order[:, :, None, None], dim=1)
        new_mean = torch.mean(elites, dim=1)
        new_std = torch.std(elites, dim=1, correction=0) + cfg.min_std
        mean = cfg.smoothing * mean + (1.0 - cfg.smoothing) * new_mean
        std = cfg.smoothing * std + (1.0 - cfg.smoothing) * new_std
        it_best = torch.argmin(scores, dim=1)
        it_score = torch.take_along_dim(scores, it_best[:, None], dim=1)[:, 0]
        cand = torch.take_along_dim(samples, it_best[:, None, None, None],
                                    dim=1)[:, 0]
        better = it_score < best_score
        best_k = torch.where(better[:, None, None], cand, best_k)
        best_score = torch.where(better, it_score, best_score)

    mean_k = torch.clamp(mean, u_min, u_max)
    mean_score = score(mean_k[:, None])[0][:, 0]
    seq_best = torch.where((mean_score <= best_score)[:, None, None], mean_k,
                           best_k)
    _, viol, cost, p_traj = score(seq_best[:, None])
    viol, cost = viol[:, 0], cost[:, 0]
    p_traj = (_centres(ssm, x0, seq_best[:, :t_len], a, b) if p_traj is None
              else p_traj[:, 0])
    out = (seq_best[:, :t_len], viol <= cfg.feas_tol, viol,
           {"cost": cost, "warm_next": seq_best, "p_traj": p_traj})
    if batched:
        return out
    *head, info = out
    return (*(v[0] for v in head), {k: v[0] for k, v in info.items()})


def _centres(ssm, x0, k_ff, a, b):
    """Tube centres (B, T, n_s) of plans k_ff (B, T, n_u) from x0 (B,
    n_s): p+ = a p + b u + mu(p, u), the centre recursion of
    :func:`multistep_reachability` (which needs no shape matrix)."""
    p, ps = x0, []
    for t in range(k_ff.shape[1]):
        mu, _ = ssm_predict(ssm, p, k_ff[:, t])
        p = p @ a.T + k_ff[:, t] @ b.T + mu
        ps.append(p)
    return torch.stack(ps, dim=1)
