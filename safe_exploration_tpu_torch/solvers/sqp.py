"""Safe-MPC NLP solver knobs and helpers — the part of
``safe_exploration_tpu/solvers/sqp.py`` the lane solver needs.

The portable single-instance NLP (``solve_safempc_nlp``, ``make_sqp_planner``)
is not ported yet (ROADMAP Queue 1, item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SqpConfig", "sqp_warm_len", "sqp_n_duals", "shift_duals"]


class SqpConfig(NamedTuple):
    """Static solver knobs; the same fields and defaults as the JAX package
    (see ``safe_exploration_tpu/solvers/sqp.py`` for each one's rationale)."""

    n_safe: int = 5
    c_safety: float = 2.5
    n_outer: int = 12          # augmented-Lagrangian (multiplier) updates
    n_inner: int = 6           # damped Gauss-Newton steps per outer iteration
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
    hessian: str = "gn"
    linesearch: str = "exact"


def _solve_spd_unrolled(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the tiny SPD system h d = rhs by an unrolled Cholesky and two
    substitutions. ``h`` is (n, n, ...) and ``rhs`` (n, ...): every "scalar"
    broadcasts over the trailing lane dims. Breakdown (h not SPD) surfaces as
    NaN in d, for the caller's fallback."""
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


def sqp_warm_len(cfg: SqpConfig) -> int:
    """Rows of the planner's warm-start matrix: safety controls + free
    performance controls."""
    if cfg.n_perf <= 0:
        return cfg.n_safe
    r = min(cfg.r_shared, cfg.n_safe, cfg.n_perf)
    return cfg.n_safe + (cfg.n_perf - r)


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
