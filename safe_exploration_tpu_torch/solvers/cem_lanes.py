"""Lane-major constrained CEM planner — port of
``safe_exploration_tpu/solvers/cem_lanes.py``.

The sample x instance product is the lane axis: scoring M sequences for B
problem instances is one lane tube rollout of width L = M * B (column index
``sample * B + instance``). The iteration machinery (per-lane elites over
the sample axis, smoothed refits, best-ever archive) stays (n_var, B).

Scoring is forward-only, so the CUDA kernels serve it (``cem_gp_impl``):

  ==================  ====================  ==============================
  cfg.gp_impl         wide scoring pass      final B-lane passes
  ==================  ====================  ==============================
  "auto", "fused"     ``cem_score``          ``gp_predict`` in the rollout
  "pallas"            ``gp_predict``         ``gp_predict``
  "xla"               plain lane form        plain lane form
  ==================  ====================  ==============================

each inside its envelope (``cem_score_supported``, ``gp_pallas_supported``;
outside it the plain lane form). A solve prepares the model once
(``prepare_posterior``; under "auto" the one ``prepare_tube_score`` made)
and every gp_predict call of the solve evaluates that posterior. Where
this differs from the JAX package: its "auto" means XLA, chosen because
XLA fused the posterior chain and the kernels measured at parity on the
TPU. Eager PyTorch fuses nothing, so here
"auto" takes the kernels, and "xla" stays as the plain yardstick. On CPU
tensors every choice computes with the kernels' plain versions (the
wrappers' convention), so the choice changes only the summation order.

``jax.random`` keys become a ``torch.Generator`` (``None``: a fresh one
seeded 0 on the planner's device) or an explicit ``noise`` tensor of the
per-iteration draws, shape (n_iterations, M, n_var, B).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from safe_exploration_tpu_torch.models.sparse_gp import SparseGPSSM
from safe_exploration_tpu_torch.models.ssm import GPSSM
from safe_exploration_tpu_torch.ops.kernels import (
    cem_score_supported,
    prepare_posterior,
    prepare_tube_score,
    tube_score_prepared,
)
from safe_exploration_tpu_torch.solvers.cem import (
    CemConfig,
    cem_warm_len,
    draw_noise,
)
from safe_exploration_tpu_torch.solvers.sqp_lanes import (
    _KERNEL_PARTS,
    _LANE_COSTS,
    _cost_lanes,
    _dist_lanes,
    _gp_of,
    _relu0,
    _rollout_y_lanes,
    _wants_sigma,
    gp_pallas_supported,
)

__all__ = ["cem_lanes_supported", "cem_plan_lanes", "make_cem_lane_solver"]


class _TubeCfg(NamedTuple):
    """The rollout knobs _rollout_y_lanes reads."""

    n_safe: int
    c_safety: float
    n_perf: int
    perf_method: str = "taylor"


def cem_lanes_supported(ssm, cost_kind: str) -> bool:
    """Whether the lane CEM covers this model and objective: a shared exact
    or inducing-point GP-SSM over the ported kernel menu, a lane
    objective."""
    if not isinstance(ssm, (GPSSM, SparseGPSSM)):
        return False
    gp = _gp_of(ssm)
    return (all(kt in _KERNEL_PARTS for kt in gp.kern_types)
            and getattr(gp, "precision", "f32") == "f32"
            and cost_kind in _LANE_COSTS)


def cem_plan_lanes(generator, ssm, x0s, k_fb, a, b, u_min, u_max, h_mat_obs,
                   h_obs, h_mat_safe, h_safe, c_safety: float, cost_kind: str,
                   cost_args: dict, cfg: CemConfig, warm=None, noise=None):
    """Constrained-CEM solve for B instances at once, lane-major.

    x0s (B, n_s), warm (B, cem_warm_len(cfg), n_u) or None. Returns
    (k_ff (B, n_safe, n_u), feasible (B,), violation (B,), info) with
    info = {cost (B,), warm_next (B, t_total, n_u), p_traj (B, n_safe, n_s)}
    — the batched-planner contract of the lane SQP.
    """
    t_len, n_u = cfg.n_safe, u_min.shape[0]
    t_total = cem_warm_len(cfg)
    bsz, n_s = x0s.shape
    r = min(cfg.r_shared, t_len, cfg.n_perf) if cfg.n_perf > 0 else 0
    m = cfg.n_samples
    dtype, device = x0s.dtype, x0s.device
    n_var = t_total * n_u

    lo = u_min.repeat(t_total)[:, None]
    hi = u_max.repeat(t_total)[:, None]
    u_range = ((u_max - u_min) * 0.5).repeat(t_total)[:, None]
    s_lift = torch.cat([torch.eye(n_s, dtype=dtype, device=device), k_fb], 0)
    bmat = s_lift.T @ s_lift
    tube_cfg = _TubeCfg(n_safe=t_len, c_safety=c_safety, n_perf=cfg.n_perf,
                        perf_method=cfg.perf_method)
    want_sigma = _wants_sigma(cost_kind, cfg.n_perf)
    consts = [k_fb, a, b, bmat]
    polys = [h_mat_obs, h_obs, h_mat_safe, h_safe]

    impl = cfg.gp_impl
    fused = (impl in ("auto", "fused")
             and cem_score_supported(ssm, n_s, cost_kind, cfg.n_perf))
    gp_impl = "pallas" if impl != "xla" and gp_pallas_supported(ssm) else "xla"
    prep = post = None
    if fused:
        # the model and constants made ready once, scored every iteration
        prep = prepare_tube_score(ssm, *consts[:3], consts[3], *polys,
                                  c_safety, t_len, cost_kind, cost_args)
        post = prep.post
    if gp_impl == "pallas" and post is None:
        post = prepare_posterior(ssm)

    def make_score(x0_cols):
        """Penalized scorer over lanes of width x0_cols.shape[1]."""

        def score(u_flat):
            y = _rollout_y_lanes(ssm, u_flat, x0_cols, *consts[:3], tube_cfg,
                                 consts[3], impl=gp_impl,
                                 want_sigma=want_sigma, post=post, r=r)
            g = _dist_lanes(y, t_len, n_s, *polys)
            viol = torch.sum(_relu0(g), dim=0)
            cost = _cost_lanes(cost_kind, cost_args, y, u_flat, t_len,
                               n_s, n_u, n_perf=cfg.n_perf, r=r)
            return cost + cfg.penalty * viol, viol, cost, y

        return score

    # sampling lanes: L = M * B, column index = sample * B + instance
    x0_wide = x0s.T.repeat(1, m)
    score_b = make_score(x0s.T)
    if fused:
        def scores_wide(u_wide):
            c, v = tube_score_prepared(prep, u_wide, x0_wide)
            return c + cfg.penalty * v
    else:
        score_wide = make_score(x0_wide)

        def scores_wide(u_wide):
            return score_wide(u_wide)[0]

    mean = (torch.zeros((n_var, bsz), dtype=dtype, device=device)
            if warm is None else torch.movedim(warm.reshape(bsz, n_var), 0, -1))
    std = (cfg.init_std * u_range).expand(n_var, bsz)
    best_k = mean
    best_score = torch.full((bsz,), float("inf"), dtype=dtype, device=device)
    if noise is None:
        noise = draw_noise(generator, (cfg.n_iterations, m, n_var, bsz),
                           dtype, device)
    else:
        noise = noise.to(dtype=dtype, device=device)
    for it in range(cfg.n_iterations):
        samples = torch.clamp(mean[None] + std[None] * noise[it], lo[None],
                              hi[None])
        samples[0] = torch.clamp(mean, lo, hi)   # elite retention
        scores = scores_wide(
            torch.movedim(samples, 0, 1).reshape(n_var, m * bsz)
        ).reshape(m, bsz)
        elite_idx = torch.argsort(scores, dim=0, stable=True)[:cfg.n_elites]
        elites = torch.take_along_dim(samples, elite_idx[:, None, :], dim=0)
        new_mean = torch.mean(elites, dim=0)
        new_std = torch.std(elites, dim=0, correction=0) + cfg.min_std
        mean = cfg.smoothing * mean + (1.0 - cfg.smoothing) * new_mean
        std = cfg.smoothing * std + (1.0 - cfg.smoothing) * new_std
        # best-ever archive per lane (strict improvement only)
        it_score, it_best = torch.min(scores, dim=0)
        cand = torch.take_along_dim(samples, it_best[None, None, :], dim=0)[0]
        better = it_score < best_score
        best_k = torch.where(better[None, :], cand, best_k)
        best_score = torch.where(better, it_score, best_score)

    # the better of (refined mean, best-ever sample) per lane
    mean_k = torch.clamp(mean, lo, hi)
    mean_score = score_b(mean_k)[0]
    seq_best = torch.where((mean_score <= best_score)[None, :], mean_k, best_k)
    _, viol, cost, y_fin = score_b(seq_best)
    p_traj = torch.movedim(y_fin[: t_len * n_s], -1, 0).reshape(bsz, t_len, n_s)
    u_mat = torch.movedim(seq_best, -1, 0).reshape(bsz, t_total, n_u)
    info = {"cost": cost, "warm_next": u_mat, "p_traj": p_traj}
    return u_mat[:, :t_len], viol <= cfg.feas_tol, viol, info


def make_cem_lane_solver(env, k_fb, a, b, c_safety, cost_kind, cost_args,
                         cfg: CemConfig):
    """Batched planner over the lane CEM:

        batch_planner(ssm, x0s (B, n_s), warm, *, generator=None, noise=None)
            -> (k_ff (B, n_safe, n_u), feasible (B,), violation (B,), info)
    """
    spec = env.spec

    def batch_planner(ssm, x0s, warm, *, generator=None, noise=None):
        return cem_plan_lanes(
            generator, ssm, x0s, k_fb, a, b, spec.u_min, spec.u_max,
            spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
            c_safety, cost_kind, cost_args, cfg, warm=warm, noise=noise)

    return batch_planner
