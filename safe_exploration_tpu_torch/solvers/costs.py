"""Planner objectives — port of ``safe_exploration_tpu/solvers/costs.py``.

A cost function has signature ``cost_fn(p_traj, q_traj, var_traj, k_ff_all)
-> scalar`` over the safety trajectory (lower = better). The lane solver
carries the same objective in its own lane form (``sqp_lanes._cost_lanes``).
"""

from __future__ import annotations

import torch

__all__ = ["tracking_cost", "exploration_cost"]


def tracking_cost(target: torch.Tensor, w_x: float = 1.0, w_u: float = 0.1,
                  w_terminal: float = 5.0):
    """Quadratic tracking toward ``target`` with control effort and a
    terminal weight."""

    def cost_fn(p_traj, q_traj, var_traj, k_ff_all):
        dx = p_traj - target
        stage = w_x * torch.sum(dx[:-1] * dx[:-1]) + w_u * torch.sum(
            k_ff_all * k_ff_all
        )
        return stage + w_terminal * torch.sum(dx[-1] * dx[-1])

    return cost_fn


def exploration_cost(scale: float = 1.0):
    """Information-seeking objective: the summed predictive std along the
    trajectory, negated (costs are minimized)."""

    def cost_fn(p_traj, q_traj, var_traj, k_ff_all):
        return -scale * torch.sum(torch.sqrt(var_traj))

    return cost_fn
