"""Inverted pendulum — port of ``safe_exploration_tpu/envs/pendulum.py``.

n_s = 2 (angle theta from upright, angular velocity omega), n_u = 1 torque;
dynamics

    theta_dot = omega
    omega_dot = (g / l) sin(theta) - (b / (m l^2)) omega + u / (m l^2)

with the unstable upright fixed point at the origin.
"""

from __future__ import annotations

import torch

from safe_exploration_tpu_torch import resolve_device
from safe_exploration_tpu_torch.envs.base import Env, EnvSpec, box_polytope

__all__ = ["make_pendulum"]


def make_pendulum(
    *,
    dt: float = 0.05,
    mass: float = 0.25,
    length: float = 0.5,
    damping: float = 0.01,
    gravity: float = 9.81,
    u_lim: float = 1.0,
    theta_safe: float = 0.35,
    omega_safe: float = 1.2,
    theta_obs: float = 0.5,
    omega_obs: float = 2.0,
    plant_noise: float = 1e-3,
    init_std: float = 0.01,
    dtype=torch.float32,
    device=None,
) -> Env:
    """Build the inverted-pendulum environment (same defaults as the JAX
    package)."""
    dev = resolve_device(device)
    inertia = mass * length * length

    def dynamics(x, u):
        theta, omega = x[..., 0], x[..., 1]
        omega_dot = (
            (gravity / length) * torch.sin(theta)
            - (damping / inertia) * omega
            + u[..., 0] / inertia
        )
        return torch.stack([omega, omega_dot], dim=-1)

    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    h_mat_safe, h_safe = box_polytope(
        f([-theta_safe, -omega_safe]), f([theta_safe, omega_safe])
    )
    h_mat_obs, h_obs = box_polytope(
        f([-theta_obs, -omega_obs]), f([theta_obs, omega_obs])
    )
    spec = EnvSpec(
        dt=f(dt),
        init_m=torch.zeros(2, dtype=dtype, device=dev),
        init_std=f([init_std, init_std]),
        u_min=f([-u_lim]),
        u_max=f([u_lim]),
        plant_noise=f([plant_noise, plant_noise]),
        target=torch.zeros(2, dtype=dtype, device=dev),
        h_mat_safe=h_mat_safe,
        h_safe=h_safe,
        h_mat_obs=h_mat_obs,
        h_obs=h_obs,
        norm_x=f([theta_obs, omega_obs]),
        norm_u=f([u_lim]),
    )
    return Env(dynamics=dynamics, spec=spec, name="pendulum")
