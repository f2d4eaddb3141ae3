"""Derivative-based safe-MPC NLP solver — port of
``safe_exploration_tpu/solvers/sqp.py``, the replacement for the
reference's IPOPT solve of the safety NLP

    min_{k_ff}  cost(tube(k_ff))
    s.t.        per-stage ellipsoid in the state polytope,
                terminal ellipsoid in the safe polytope,
                u_min <= k_ff <= u_max

by an augmented-Lagrangian method (Rockafellar inequality form) with damped
projected-Newton inner iterations, a Gauss-Newton feasibility polish, an
optional rescue burst and a violation-gated extra polish, all on a fixed
budget.

The JAX package jit-compiles the solve; here it runs eagerly, one instance
at a time, with no read-back to the host inside a solve (the gated extra
polish runs and is selected with ``torch.where``). Derivatives:

  * ``solve_al_nlp_gn`` (``hessian="gn"``, the default) takes the rollout's
    Jacobian in reverse mode, one backward pass through ny folded copies of
    the rollout (ny = 40 outputs for the pendulum, 480 for the cart-pole),
    and exact derivatives of the tiny y-space maps (``torch.func``);
  * ``solve_al_nlp`` (``hessian="exact"``) takes ``torch.func.hessian``
    (forward over reverse) of the augmented Lagrangian through the whole
    tube.

JAX takes the GN Jacobian in forward mode (``jacfwd``, n_var = 5 / 18
tangents). Eager forward mode, ``torch.func.jacfwd`` or dual tensors over
n_var folded copies alike, costs 6-18 times the rollout on the host (its
formulas route zero tangents through slow decompositions); reverse mode
through plain autograd costs about 3 times the rollout, whatever ny, on a
device where the copies cost no launches (``solvers/nlp_times.py`` times
both). The line-search candidates go through the rollout as one leading
batch dimension.
The Newton systems are factored by ``torch.linalg.cholesky_ex`` at every
size (the JAX package unrolls them up to 24 variables to fuse them into its
compiled step; eagerly, the unroll would cost O(n^3) launches); a failed
factor gives NaN, as ``jnp.linalg.cholesky`` does, so the strongly damped
fallback step keeps its meaning.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.func import grad, grad_and_value, hessian, jacfwd, vmap

from safe_exploration_tpu_torch.reachability.onestep import (
    multistep_reachability,
)
from safe_exploration_tpu_torch.reachability.propagation import (
    multi_step_propagation,
)
from safe_exploration_tpu_torch.reachability.safety import (
    lin_ellipsoid_safety_distance,
)

__all__ = ["SqpConfig", "solve_al_nlp", "solve_al_nlp_gn",
           "solve_safempc_nlp", "make_sqp_planner", "sqp_warm_len",
           "sqp_n_duals", "shift_duals"]


class SqpConfig(NamedTuple):
    """Static solver knobs; the same fields and defaults as the JAX package
    (see ``safe_exploration_tpu/solvers/sqp.py`` for each one's rationale)."""

    n_safe: int = 5
    c_safety: float = 2.5
    n_outer: int = 12          # augmented-Lagrangian (multiplier) updates
    n_inner: int = 6           # damped Newton steps per outer iteration
    mu0: float = 50.0          # initial penalty
    mu_growth: float = 2.5     # geometric penalty growth per outer iteration
    newton_damping: float = 1e-6
    feas_tol: float = 1e-4     # feasibility gate on the summed violation
    n_linesearch: int = 3      # backtracking candidates (1, 1/2, 1/4, ...)
    n_perf: int = 0
    r_shared: int = 1
    perf_method: str = "taylor"
    opt_k_fb: bool = False
    k_fb_bound: float = 2.0
    n_polish: int = 3          # GN feasibility-polish steps after the AL loop
    n_polish_extra: int = 0    # violation-gated extra polish steps
    n_rescue_outer: int = 0    # rescue AL outers after the polish
    hessian: str = "gn"        # "gn" | "exact"
    linesearch: str = "exact"  # "exact" | "linearized" (GN path only)


def _solve_spd_unrolled(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the tiny SPD system h d = rhs by an unrolled Cholesky and two
    substitutions. ``h`` is (n, n, ...) and ``rhs`` (n, ...): every "scalar"
    broadcasts over the trailing lane dims (the lane solver's layout).
    Breakdown (h not SPD) surfaces as NaN in d, for the caller's fallback."""
    n = h.shape[0]
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = h[j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        l[j][j] = torch.sqrt(s)
        inv_d = 1.0 / l[j][j]
        for i in range(j + 1, n):
            s = h[i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    d = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * d[k]
        d[i] = s / l[i][i]
    return torch.stack(d)


def _newton_solve(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the SPD systems h d = rhs, h (..., n, n), rhs (..., n), through
    ``cholesky_ex`` (no read-back); a system whose factorization fails gets
    an all-NaN d."""
    l, info = torch.linalg.cholesky_ex(h)
    l = torch.where((info == 0)[..., None, None], l, torch.nan)
    y = torch.linalg.solve_triangular(l, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(l.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def _damped_direction(h: torch.Tensor, rhs: torch.Tensor,
                      damping: float) -> torch.Tensor:
    """The Levenberg-damped Newton direction of the symmetrized ``h``, or
    the strongly damped (gradient-like) one where that factorization fails;
    both systems in one factorization call."""
    n = h.shape[-1]
    diag_scale = torch.maximum(torch.max(torch.abs(torch.diagonal(h))),
                               torch.ones((), dtype=h.dtype, device=h.device))
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    hs = 0.5 * (h + h.T)
    pair = torch.stack([hs + (damping * diag_scale) * eye,
                        hs + diag_scale * eye])
    d = _newton_solve(pair, rhs.expand(2, n))
    return torch.where(torch.all(torch.isfinite(d[0])), d[0], d[1])


def _rollout_jacobian(fn: Callable, u: torch.Tensor, m: int):
    """(J (m, n), fn(u) (m,)) of fn: R^n -> R^m in one backward pass: m
    folded copies of u (a leading batch axis, which ``fn`` takes), copy i
    pulled back with the unit cotangent e_i."""
    uu = u.detach().expand(m, u.shape[-1]).clone().requires_grad_(True)
    eye = torch.eye(m, dtype=u.dtype, device=u.device)
    with torch.enable_grad():
        y = fn(uu)
        (jac,) = torch.autograd.grad(y, uu, grad_outputs=eye)
    return jac, y[0].detach()


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0)``: its derivative at 0 is 1/2, as JAX's."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _pick(vals: torch.Tensor, cands: torch.Tensor, ref: torch.Tensor,
          u: torch.Tensor) -> torch.Tensor:
    """The first candidate of least value where it beats ``ref``, else
    ``u``; chosen on the device."""
    best = torch.argmin(vals).reshape(1)
    take = vals.index_select(0, best)[0] < ref
    return torch.where(take, cands.index_select(0, best)[0], u)


def _candidates(u, d, alphas, lo, hi):
    return torch.clamp(u + alphas[:, None] * d, lo, hi)


def _build_constraint_fn(ssm, x0, k_fb_all, a, b, cfg: SqpConfig, h_mat_obs,
                         h_obs, h_mat_safe, h_safe, cost_fn: Callable):
    """Return the closures (objective, constraints, outputs, cost_small,
    dist_small) of one safety(+performance) NLP over the flat decision
    vector ``u_flat = [k_ff (n_safe * n_u) | u_perf_free ((n_perf -
    r_shared) * n_u) | dK (n_safe * n_u * n_s, with opt_k_fb)]``.

    ``outputs`` packs the rollout y = [p, Q, var (the safety tube) | p, Sigma,
    var (the perf trajectory, with n_perf)]; ``cost_small(y, u_flat)`` and
    ``dist_small(y)`` are the objective and the constraint margins as tiny
    functions of y (the Gauss-Newton split). ``constraints``, ``outputs``
    and ``dist_small`` take leading batch dims on u_flat / y (the
    line-search candidates, the forward-mode tangents' copies); the
    objective and ``cost_small`` take one decision vector."""
    t_len, n_u, n_s = k_fb_all.shape
    r = min(cfg.r_shared, t_len, cfg.n_perf) if cfg.n_perf > 0 else 0
    n_safe_flat = t_len * n_u
    n_ctrl_flat = sqp_warm_len(cfg) * n_u
    n_free = (n_ctrl_flat - n_safe_flat) // n_u

    def split(u_flat):
        lead = u_flat.shape[:-1]
        k_ff_all = u_flat[..., :n_safe_flat].reshape(lead + (t_len, n_u))
        u_perf_free = u_flat[..., n_safe_flat:n_ctrl_flat].reshape(
            lead + (n_free, n_u))
        return k_ff_all, u_perf_free

    def stage_gains(u_flat):
        if not cfg.opt_k_fb:
            return k_fb_all
        return k_fb_all + u_flat[..., n_ctrl_flat:].reshape(
            u_flat.shape[:-1] + (t_len, n_u, n_s))

    def start(u_flat):
        return x0.expand(u_flat.shape[:-1] + (n_s,))

    def rollout(u_flat):
        k_ff_all, _ = split(u_flat)
        return multistep_reachability(ssm, start(u_flat), k_ff_all,
                                      stage_gains(u_flat), a, b, cfg.c_safety)

    def perf_controls(u_flat):
        k_ff_all, u_perf_free = split(u_flat)
        return torch.cat([k_ff_all[..., :r, :], u_perf_free], dim=-2)

    def perf_rollout(u_flat):
        return multi_step_propagation(ssm, start(u_flat),
                                      perf_controls(u_flat), a, b,
                                      method=cfg.perf_method)

    if cfg.n_perf > 0:
        def objective(u_flat):
            p_traj, sigma_traj, var_traj = perf_rollout(u_flat)
            return cost_fn(p_traj, sigma_traj, var_traj,
                           perf_controls(u_flat))
    else:
        def objective(u_flat):
            p_traj, q_traj, var_traj = rollout(u_flat)
            return cost_fn(p_traj, q_traj, var_traj, split(u_flat)[0])

    def margins(p_traj, q_traj):
        d_stage = lin_ellipsoid_safety_distance(p_traj, q_traj, h_mat_obs,
                                                h_obs)
        d_term = lin_ellipsoid_safety_distance(
            p_traj[..., -1, :], q_traj[..., -1, :, :], h_mat_safe, h_safe)
        return torch.cat([d_stage.flatten(-2), d_term], dim=-1)

    def constraints(u_flat):
        p_traj, q_traj, _ = rollout(u_flat)
        return margins(p_traj, q_traj)

    n_perf_blk = cfg.n_perf if cfg.n_perf > 0 else 0
    shapes = [(t_len, n_s), (t_len, n_s, n_s), (t_len, n_s)]
    if n_perf_blk:
        shapes += [(n_perf_blk, n_s), (n_perf_blk, n_s, n_s),
                   (n_perf_blk, n_s)]
    offs = [0]
    for shape in shapes:
        offs.append(offs[-1] + math.prod(shape))

    def _unpack(y):
        lead = y.shape[:-1]
        parts = [y[..., offs[i]:offs[i + 1]].reshape(lead + shape)
                 for i, shape in enumerate(shapes)]
        return parts[:3] + [tuple(parts[3:]) if n_perf_blk else None]

    def outputs(u_flat):
        blocks = list(rollout(u_flat))
        if n_perf_blk:
            blocks += perf_rollout(u_flat)
        lead = u_flat.shape[:-1]
        return torch.cat([t.reshape(lead + (-1,)) for t in blocks], dim=-1)

    def cost_small(y, u_flat):
        p_traj, q_traj, var_traj, perf = _unpack(y)
        if n_perf_blk:
            return cost_fn(*perf, perf_controls(u_flat))
        return cost_fn(p_traj, q_traj, var_traj, split(u_flat)[0])

    def dist_small(y):
        p_traj, q_traj, _, _ = _unpack(y)
        return margins(p_traj, q_traj)

    return objective, constraints, outputs, cost_small, dist_small


def sqp_warm_len(cfg: SqpConfig) -> int:
    """Rows of the planner's warm-start matrix: safety controls + free
    performance controls."""
    if cfg.n_perf <= 0:
        return cfg.n_safe
    r = min(cfg.r_shared, cfg.n_safe, cfg.n_perf)
    return cfg.n_safe + (cfg.n_perf - r)


def _alphas(n: int, like: torch.Tensor) -> torch.Tensor:
    """Backtracking step fractions 1, 1/2, 1/4, ... (n of them), made on the
    device (a host list would be a synchronizing copy)."""
    return 0.5 ** torch.arange(n, dtype=like.dtype, device=like.device)


def _make_polish(cfg: SqpConfig, jac_and_g: Callable, violations: Callable,
                 lo, hi, like: torch.Tensor) -> Callable:
    """The Gauss-Newton feasibility polish: damped GN steps on the violation
    only, each backtracking over 1, 1/2, 1/4, 1/8 of its direction and
    never increasing the summed violation. ``jac_and_g(u) -> (dg/du, g)``;
    ``violations(cands)`` sums each candidate row's violation."""
    eye = torch.eye(like.shape[0], dtype=like.dtype, device=like.device)
    alphas = _alphas(4, like)

    def do_polish(u, n_steps=0):
        for _ in range(n_steps or cfg.n_polish):
            jac, g = jac_and_g(u)
            v = _relu(g)
            jtv = jac.T @ v
            jtj = jac.T @ (jac * (g > 0.0).to(u.dtype)[:, None])
            d = _newton_solve(jtj + 1e-6 * eye, -jtv)
            cands = _candidates(u, d, alphas, lo, hi)
            u = _pick(violations(cands), cands, torch.sum(v), u)
        return u

    return do_polish


def _schedule(cfg: SqpConfig, outer_step: Callable, do_polish: Callable,
              gate_fn: Callable, u: torch.Tensor, lam: torch.Tensor):
    """The fixed budget both cores share: ``n_outer`` AL outer steps, the
    polish, the rescue burst (more outer steps from the polished primal
    with fresh multipliers at the schedule's final penalty, then the polish
    again) and the violation-gated extra polish, branch-free: both of its
    branches run and ``torch.where`` keeps the polished one where the
    gate's violation is above ``feas_tol``. Returns (u_fin, lam_fin,
    g_fin); ``gate_fn(u)`` gives the constraints."""
    kw = {"dtype": u.dtype, "device": u.device}
    mu = torch.full((), cfg.mu0, **kw)
    for _ in range(cfg.n_outer):
        u, lam, mu = outer_step(u, lam, mu)
    lam_fin = lam
    if cfg.n_polish > 0:
        u = do_polish(u)
    if cfg.n_rescue_outer > 0:
        lam_r = torch.zeros_like(lam_fin)
        mu_r = torch.full((), cfg.mu0 * cfg.mu_growth ** cfg.n_outer, **kw)
        for _ in range(cfg.n_rescue_outer):
            u, lam_r, mu_r = outer_step(u, lam_r, mu_r)
        if cfg.n_polish > 0:
            u = do_polish(u)
    g_gate = gate_fn(u)
    if cfg.n_polish_extra > 0:
        still_bad = torch.sum(_relu(g_gate)) > cfg.feas_tol
        u2 = do_polish(u, cfg.n_polish_extra)
        g2 = gate_fn(u2)
        return (torch.where(still_bad, u2, u), lam_fin,
                torch.where(still_bad, g2, g_gate))
    return u, lam_fin, g_gate


def solve_al_nlp(objective: Callable, constraints: Callable,
                 u0: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 cfg: SqpConfig, lam_init: torch.Tensor | None = None):
    """Generic fixed-budget augmented-Lagrangian NLP core with the exact
    Hessian (``torch.func.hessian`` of the AL, forward over reverse, through
    the whole objective and constraints):

        min_u objective(u)  s.t.  constraints(u) <= 0,  lo <= u <= hi

    AL outer loop, damped projected-Newton inner steps and the
    :func:`_schedule` of the JAX package; ``constraints`` takes leading
    batch dims (the polish's Jacobian copies and candidates). Returns
    (u_fin, lam_fin, g_fin): the final primal, multipliers and
    constraints."""

    def al_value(u, lam, mu):
        g = constraints(u)
        shifted = _relu(lam + mu * g)
        return objective(u) + (1.0 / (2.0 * mu)) * torch.sum(
            shifted * shifted - lam * lam)

    al_grad_value = grad_and_value(al_value)
    al_hess = hessian(al_value)
    alphas = _alphas(cfg.n_linesearch, u0)

    def newton_step(u, lam, mu):
        g, f0 = al_grad_value(u, lam, mu)
        d = _damped_direction(al_hess(u, lam, mu), -g, cfg.newton_damping)
        cands = _candidates(u, d, alphas, lo, hi)
        vals = vmap(al_value, in_dims=(0, None, None))(cands, lam, mu)
        vals = torch.where(torch.isfinite(vals), vals, torch.inf)
        return _pick(vals, cands, f0, u)

    def outer_step(u, lam, mu):
        for _ in range(cfg.n_inner):
            u = newton_step(u, lam, mu)
        lam = _relu(lam + mu * constraints(u))
        return u, lam, mu * cfg.mu_growth

    u = torch.clamp(u0, lo, hi)
    lam = (torch.zeros_like(constraints(u)) if lam_init is None
           else lam_init)
    n_con = lam.shape[0]
    do_polish = _make_polish(
        cfg, lambda uu: _rollout_jacobian(constraints, uu, n_con),
        lambda cands: torch.sum(_relu(constraints(cands)), dim=-1), lo, hi,
        u0)
    return _schedule(cfg, outer_step, do_polish, constraints, u, lam)


def solve_al_nlp_gn(outputs: Callable, cost_small: Callable,
                    dist_small: Callable, u0: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, cfg: SqpConfig,
                    lam_init: torch.Tensor):
    """Gauss-Newton augmented-Lagrangian core (``cfg.hessian == "gn"``).

    The schedule of :func:`solve_al_nlp`, with each Newton step's AL
    gradient and curvature from ONE Jacobian of the rollout y(u)
    (:func:`_rollout_jacobian`):

        grad = Jy^T (dF/dy + Gy^T s) + dF/du
        H   ~= [Jy; I]^T d2F [Jy; I] + mu (Gy Jy)^T diag(active) (Gy Jy)

    with F = cost_small(y, u), G = dist_small(y), s = max(lam + mu g, 0);
    the derivatives of F and G are exact (tiny maps of y, ``torch.func``).
    ``outputs`` and ``dist_small`` take leading batch dims (the Jacobian's
    copies, the line-search candidates); ``cost_small`` one (y, u). Returns
    (u_fin, lam_fin, g_fin)."""

    def al_from(y, u, lam, mu):
        s = _relu(lam + mu * dist_small(y))
        return cost_small(y, u) + torch.sum(s * s - lam * lam) / (2.0 * mu)

    cost_of = vmap(cost_small)

    def al_batch(ys, us, lam, mu):
        """al_from of each candidate (rows of ys, us)."""
        s = _relu(lam + mu * dist_small(ys))
        return cost_of(ys, us) + torch.sum(s * s - lam * lam,
                                           dim=-1) / (2.0 * mu)

    ny = outputs(u0).shape[-1]

    def jac_out(u):                              # u -> (Jy (ny, n_var), y)
        return _rollout_jacobian(outputs, u, ny)

    jac_dist = jacfwd(dist_small)                # y -> Gy (n_con, ny)

    def cost_joint(yu, ny):
        return cost_small(yu[:ny], yu[ny:])

    cost_grad = grad(cost_joint)
    cost_hess = hessian(cost_joint)
    alphas = _alphas(cfg.n_linesearch, u0)

    def gn_step(u, lam, mu):
        jy, y = jac_out(u)
        g = dist_small(y)
        s = _relu(lam + mu * g)
        act = (s > 0.0).to(u.dtype)
        gy = jac_dist(y)
        # cost_small's gradient and Hessian in (y, u) jointly: fy, fu, hyy,
        # huu and the cross term hyu as blocks
        yu = torch.cat([y, u])
        fyu = cost_grad(yu, ny)
        hfull = cost_hess(yu, ny)
        fy, fu = fyu[:ny], fyu[ny:]
        hyy, hyu, huu = hfull[:ny, :ny], hfull[:ny, ny:], hfull[ny:, ny:]

        f0 = al_from(y, u, lam, mu)
        grad_al = jy.T @ (fy + gy.T @ s) + fu
        gj = gy @ jy                                      # (n_con, n_var)
        h = (jy.T @ (hyy @ jy + hyu) + hyu.T @ jy + huu
             + mu * gj.T @ (gj * act[:, None]))
        d = _damped_direction(h, -grad_al, cfg.newton_damping)
        cands = _candidates(u, d, alphas, lo, hi)
        if cfg.linesearch == "linearized":
            # the candidates scored on the linearized rollout y + Jy (u' - u)
            vals = al_batch(y + (cands - u) @ jy.T, cands, lam, mu)
        else:
            vals = al_batch(outputs(cands), cands, lam, mu)
        vals = torch.where(torch.isfinite(vals), vals, torch.inf)
        return _pick(vals, cands, f0, u)

    def outer_step(u, lam, mu):
        for _ in range(cfg.n_inner):
            u = gn_step(u, lam, mu)
        lam = _relu(lam + mu * dist_small(outputs(u)))
        return u, lam, mu * cfg.mu_growth

    def jac_and_g(u):
        jy, y = jac_out(u)
        return jac_dist(y) @ jy, dist_small(y)

    def gate_fn(uu):
        return dist_small(outputs(uu))

    do_polish = _make_polish(
        cfg, jac_and_g, lambda cands: torch.sum(_relu(gate_fn(cands)), dim=-1),
        lo, hi, u0)
    return _schedule(cfg, outer_step, do_polish, gate_fn,
                     torch.clamp(u0, lo, hi), lam_init)


def solve_safempc_nlp(ssm, x0, u_init, k_fb, a, b, u_min, u_max, h_mat_obs,
                      h_obs, h_mat_safe, h_safe, cost_fn: Callable,
                      cfg: SqpConfig, lam_init: torch.Tensor | None = None):
    """Solve one safety(+performance) NLP from the warm start ``u_init``
    (``sqp_warm_len(cfg)`` rows of n_u) and the optional dual warm start
    ``lam_init``.

    Returns (k_ff (n_safe, n_u), feasible, violation, info) with info =
    {cost, max_constraint, warm_next (the whole decision matrix), lam, and
    k_fb_delta (n_safe, n_u, n_s) with opt_k_fb}; the flags and numbers stay
    on the device."""
    t_len = cfg.n_safe
    n_u = u_min.shape[0]
    n_s = x0.shape[0]
    dtype, device = x0.dtype, x0.device
    k_fb_all = k_fb.expand(t_len, *k_fb.shape)
    objective, constraints, outputs, cost_small, dist_small = (
        _build_constraint_fn(ssm, x0, k_fb_all, a, b, cfg, h_mat_obs, h_obs,
                             h_mat_safe, h_safe, cost_fn))

    t_total = sqp_warm_len(cfg)
    lo, hi = u_min.repeat(t_total), u_max.repeat(t_total)
    u0 = u_init.reshape(-1)
    if cfg.opt_k_fb:
        n_dk = t_len * n_u * n_s
        bound = torch.full((n_dk,), cfg.k_fb_bound, dtype=dtype,
                           device=device)
        lo, hi = torch.cat([lo, -bound]), torch.cat([hi, bound])
        u0 = torch.cat([u0, torch.zeros((n_dk,), dtype=dtype,
                                        device=device)])
    n_con = t_len * h_obs.shape[0] + h_safe.shape[0]
    lam0 = (torch.zeros((n_con,), dtype=dtype, device=device)
            if lam_init is None else lam_init)
    if cfg.hessian == "gn":
        u_fin, lam_fin, g_fin = solve_al_nlp_gn(
            outputs, cost_small, dist_small, u0, lo, hi, cfg, lam0)
    else:
        u_fin, lam_fin, g_fin = solve_al_nlp(
            objective, constraints, u0, lo, hi, cfg, lam_init=lam0)
    violation = torch.sum(_relu(g_fin))
    feasible = violation <= cfg.feas_tol
    n_ctrl_flat = t_total * n_u
    u_mat = u_fin[:n_ctrl_flat].reshape(t_total, n_u)
    info = {
        "cost": objective(u_fin),
        "max_constraint": torch.max(g_fin),
        "warm_next": u_mat,
        "lam": lam_fin,
    }
    if cfg.opt_k_fb:
        info["k_fb_delta"] = u_fin[n_ctrl_flat:].reshape(t_len, n_u, n_s)
    return u_mat[:t_len], feasible, violation, info


def make_sqp_planner(env, k_fb, a, b, cost_fn: Callable, cfg: SqpConfig):
    """The NLP solve in the single-instance planner protocol
    ``planner(generator, ssm, x0, warm_mean, lam=None, noise=None) ->
    (k_ff, feasible, violation, info)``; the solver is deterministic, so
    ``generator`` and ``noise`` are unused (the JAX package's key is too);
    ``lam`` is the dual warm start (see :func:`sqp_n_duals`)."""
    spec = env.spec

    def planner(generator, ssm, x0, warm_mean, lam=None, noise=None):
        del generator, noise
        return solve_safempc_nlp(
            ssm, x0, warm_mean, k_fb, a, b, spec.u_min, spec.u_max,
            spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe,
            cost_fn, cfg, lam_init=lam)

    return planner


def sqp_n_duals(env, cfg: SqpConfig) -> int:
    """Number of inequality multipliers of the safety NLP."""
    spec = env.spec
    return cfg.n_safe * spec.h_obs.shape[0] + spec.h_safe.shape[0]


def shift_duals(lam: torch.Tensor, n_safe: int, n_obs: int) -> torch.Tensor:
    """Receding-horizon dual shift over the last axis of ``lam`` (...,
    n_duals): stage-t multipliers take stage t+1's (last duplicated); the
    terminal multipliers carry over."""
    lead = lam.shape[:-1]
    stage = lam[..., : n_safe * n_obs].reshape(lead + (n_safe, n_obs))
    stage = torch.cat([stage[..., 1:, :], stage[..., -1:, :]], dim=-2)
    return torch.cat([stage.reshape(lead + (n_safe * n_obs,)),
                      lam[..., n_safe * n_obs:]], dim=-1)
