"""Monte-Carlo uncertainty estimation — port of
``safe_exploration_tpu/runtime/uncertainty.py``: the empirical check that
real closed-loop trajectories stay inside the predicted ellipsoid tubes.

The tube of (x0, plan) is predicted once; the noisy plant is then rolled
out ``n_rollouts`` times under the planned feedback policy, the rollouts a
leading batch dimension of one rollout loop (the JAX package vmaps over
keys). Their plant noise (n_rollouts, T, n_s) is drawn up front from a
``torch.Generator`` or handed in as ``noise``.
"""

from __future__ import annotations

from typing import Any

import torch

from safe_exploration_tpu_torch.envs.base import Env
from safe_exploration_tpu_torch.reachability.onestep import (
    multistep_reachability,
)
from safe_exploration_tpu_torch.reachability.safety import (
    verify_trajectory_safety,
)

__all__ = ["run_uncertainty_estimation"]


def run_uncertainty_estimation(
    env: Env,
    ssm,
    a: torch.Tensor,
    b: torch.Tensor,
    k_fb: torch.Tensor,
    *,
    x0: torch.Tensor,
    k_ff_all: torch.Tensor,
    c_safety: float = 2.0,
    n_rollouts: int = 256,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
    metrics: Any = None,
) -> dict:
    """Predict the tube for (x0, plan), then roll the true noisy plant
    ``n_rollouts`` times. ``noise`` (n_rollouts, T, n_s), standard normal,
    replaces the draws of ``generator`` (``None``: a CPU generator seeded
    0).

    Returns per-stage containment rates, overall containment, the fraction
    of rollouts with any state-constraint violation, and the tube (p_traj,
    q_traj)."""
    t_len, n_s = k_ff_all.shape[0], env.spec.n_s
    k_fb_all = k_fb.expand(t_len, *k_fb.shape)
    p_traj, q_traj, _ = multistep_reachability(
        ssm, x0, k_ff_all, k_fb_all, a, b, c_safety)
    if noise is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        noise = torch.randn((n_rollouts, t_len, n_s), generator=generator,
                            dtype=a.dtype, device=generator.device)
    noise = torch.as_tensor(noise).to(dtype=a.dtype, device=a.device)
    ok, contain = verify_trajectory_safety(
        env, None, x0, k_ff_all, k_fb_all, p_traj, q_traj, noise=noise)

    # the JAX package's f32 means, read back to the host once
    f32 = torch.float32
    per_stage = torch.mean(contain.to(f32), dim=0)
    overall = torch.mean(torch.all(contain, dim=1).to(f32))
    violation_rate = 1.0 - torch.mean(ok.to(f32))
    host = torch.cat([per_stage, overall[None], violation_rate[None]]).cpu()
    result = {
        "per_stage_containment": host[:t_len].tolist(),
        "overall_containment": float(host[t_len]),
        "violation_rate": float(host[t_len + 1]),
        "p_traj": p_traj,
        "q_traj": q_traj,
    }
    if metrics is not None:
        for t, v in enumerate(result["per_stage_containment"]):
            metrics.log_scalar("containment", v, step=t)
        metrics.log_scalar("overall_containment",
                           result["overall_containment"], step=0)
        metrics.log_scalar("violation_rate", result["violation_rate"],
                           step=0)
        metrics.flush()
    return result
