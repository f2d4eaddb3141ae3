"""Ellipsoid-vs-polytope safety margins and trajectory verification — port
of ``safe_exploration_tpu/reachability/safety.py``.

``jax.random`` keys become ``torch.Generator``s; the plant-noise draws of
:func:`verify_trajectory_safety` can be given explicitly instead.
"""

from __future__ import annotations

import torch

from safe_exploration_tpu_torch.envs.base import Env, env_step

__all__ = [
    "lin_ellipsoid_safety_distance",
    "is_ellipsoid_inside_polytope",
    "trajectory_inside_ellipsoids",
    "verify_trajectory_safety",
    "sample_inside_polytope",
]


def lin_ellipsoid_safety_distance(p, q, h_mat, h_vec):
    """Signed margins ``h_i^T p + sqrt(h_i^T Q h_i) - h_i`` of E(p, Q)
    against {x : H x <= h}, for p (..., n), Q (..., n, n) -> (..., m); all
    <= 0 iff the ellipsoid is inside the polytope."""
    hqh = torch.sum((h_mat @ q) * h_mat, dim=-1)
    support = torch.sqrt(torch.maximum(hqh, torch.zeros_like(hqh)))
    return p @ h_mat.T + support - h_vec


def is_ellipsoid_inside_polytope(p, q, h_mat, h_vec):
    """Containment test on the margins (<= 0)."""
    return torch.all(lin_ellipsoid_safety_distance(p, q, h_mat, h_vec) <= 0.0,
                     dim=-1)


def trajectory_inside_ellipsoids(x_traj, p_traj, q_traj):
    """Per stage: is the realized state (..., T, n) inside the predicted
    ellipsoid (p (T, n), Q (T, n, n))? Leading dims of ``x_traj`` are a
    batch of rollouts."""
    d = (x_traj - p_traj)[..., None]
    sol = torch.linalg.solve(q_traj, d)
    return (d * sol).sum((-2, -1)) <= 1.0


def verify_trajectory_safety(env: Env, generator, x0, k_ff_all, k_fb_all,
                             p_traj, q_traj, *, noise=None):
    """Roll the noisy plant under the planned feedback policy (feedback
    relative to the previous stage center; x0 at stage 0) and check the
    state constraints and the containment in the predicted tube. ``noise``
    (..., T, n_s) replaces the standard-normal plant draws of ``generator``;
    its leading dims are a batch of rollouts from the same x0 (the JAX
    package's ``vmap`` over keys). Returns (all constraints hold (...),
    per-stage containment (..., T))."""
    spec = env.spec
    p_prev = torch.cat([x0[None], p_traj[:-1]], dim=0)
    lead = () if noise is None else tuple(noise.shape[:-2])
    x, xs = x0.expand(lead + x0.shape), []
    for t in range(k_ff_all.shape[0]):
        u = k_ff_all[t] + (x - p_prev[t]) @ k_fb_all[t].T
        _, x = env_step(env, x, u, generator=generator,
                        noise=None if noise is None else noise[..., t, :])
        xs.append(x)
    x_traj = torch.stack(xs, dim=-2)
    margins = x_traj @ spec.h_mat_obs.T - spec.h_obs
    ok = torch.all((margins <= 0.0).flatten(-2), dim=-1)
    return ok, trajectory_inside_ellipsoids(x_traj, p_traj, q_traj)


def sample_inside_polytope(generator, num, h_mat, h_vec, box):
    """``num`` points uniform in the box [-box, box] with a flag for
    membership in {H x <= h} (callers mask instead of rejecting)."""
    dev = box.device if generator is None else generator.device
    u = torch.rand((num, h_mat.shape[1]), generator=generator,
                   dtype=box.dtype, device=dev).to(box.device)
    pts = (2.0 * u - 1.0) * box
    return pts, torch.all(pts @ h_mat.T - h_vec <= 0.0, dim=-1)
