"""Planner objectives — port of ``safe_exploration_tpu/solvers/costs.py``.

A cost function has signature ``cost_fn(p_traj, q_traj, var_traj, k_ff_all)
-> scalar`` over the safety trajectory (lower = better). The lane solver
carries the same objective in its own lane form (``sqp_lanes._cost_lanes``).
"""

from __future__ import annotations

import torch

__all__ = ["tracking_cost", "exploration_cost", "risk_tracking_cost"]


def _total(x: torch.Tensor) -> torch.Tensor:
    """Sum of all elements as a (1,) tensor: the costs are differentiated in
    forward mode (the safe-MPC NLP), where a 0-d dual tensor combined with a
    Python scalar gets a float64 tangent."""
    return torch.sum(x.reshape(-1), dim=0, keepdim=True)


def tracking_cost(target: torch.Tensor, w_x: float = 1.0, w_u: float = 0.1,
                  w_terminal: float = 5.0):
    """Quadratic tracking toward ``target`` with control effort and a
    terminal weight."""

    def cost_fn(p_traj, q_traj, var_traj, k_ff_all):
        dx = p_traj - target
        stage = w_x * _total(dx[:-1] * dx[:-1]) + w_u * _total(
            k_ff_all * k_ff_all
        )
        return (stage + w_terminal * _total(dx[-1] * dx[-1]))[0]

    return cost_fn


def risk_tracking_cost(target: torch.Tensor, w_x: float = 1.0,
                       w_u: float = 0.1, w_terminal: float = 5.0,
                       w_sigma: float = 1.0):
    """Risk-sensitive tracking: the quadratic tracking objective plus a
    variance price ``w_sigma * sum_t trace(Sigma_t)`` on the propagated
    state covariance (the performance trajectory's Sigma, which differs
    between ``taylor`` and ``mean_equivalent``). With ``n_perf = 0`` the
    same functional reads the safety tube's shapes q_traj, so trace(Q_t)
    prices the tube's growth."""

    def cost_fn(p_traj, q_traj, var_traj, k_ff_all):
        dx = p_traj - target
        stage = w_x * _total(dx[:-1] * dx[:-1]) + w_u * _total(
            k_ff_all * k_ff_all
        )
        term = w_terminal * _total(dx[-1] * dx[-1])
        risk = w_sigma * _total(torch.diagonal(q_traj, dim1=-2, dim2=-1))
        return (stage + term + risk)[0]

    return cost_fn


def exploration_cost(scale: float = 1.0):
    """Information-seeking objective: the summed predictive std along the
    trajectory, negated (costs are minimized)."""

    def cost_fn(p_traj, q_traj, var_traj, k_ff_all):
        return (-scale * _total(torch.sqrt(var_traj)))[0]

    return cost_fn
