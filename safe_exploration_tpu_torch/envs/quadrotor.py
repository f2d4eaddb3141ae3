"""Planar quadrotor — port of ``safe_exploration_tpu/envs/quadrotor.py``
(BASELINE config 5, the 6-D extension plant).

States (px, vx, pz, vz, phi, phi_dot): planar position and velocity
interleaved, then the roll angle and rate. Controls (u1, u2): rotor-thrust
deviations from hover, so the origin is an equilibrium at u = 0:

    vx_dot   = -(T1 + T2) sin(phi) / m
    vz_dot   =  (T1 + T2) cos(phi) / m - g
    phi_ddot =  (T2 - T1) * arm / inertia,      T_i = m g / 2 + u_i
"""

from __future__ import annotations

import torch

from safe_exploration_tpu_torch import resolve_device
from safe_exploration_tpu_torch.envs.base import Env, EnvSpec, box_polytope

__all__ = ["make_quadrotor"]


def make_quadrotor(
    *,
    dt: float = 0.05,
    mass: float = 0.5,
    arm: float = 0.2,
    inertia: float = 0.005,
    gravity: float = 9.81,
    u_lim: float = 1.5,
    pos_safe: float = 0.5,
    vel_safe: float = 0.8,
    phi_safe: float = 0.3,
    phidot_safe: float = 1.5,
    plant_noise: float = 5e-4,
    init_std: float = 0.005,
    dtype=torch.float32,
    device=None,
) -> Env:
    """Build the planar quadrotor (same defaults as the JAX package)."""
    dev = resolve_device(device)
    hover = mass * gravity / 2.0

    def dynamics(x, u):
        vx, vz, phi, phid = x[..., 1], x[..., 3], x[..., 4], x[..., 5]
        t1 = hover + u[..., 0]
        t2 = hover + u[..., 1]
        thrust = t1 + t2
        ax = -thrust * torch.sin(phi) / mass
        az = thrust * torch.cos(phi) / mass - gravity
        aphi = (t2 - t1) * arm / inertia
        return torch.stack([vx, ax, vz, az, phid, aphi], dim=-1)

    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    lo_s = f([-pos_safe, -vel_safe, -pos_safe, -vel_safe, -phi_safe,
              -phidot_safe])
    hi_s = -lo_s
    lo_o, hi_o = 1.5 * lo_s, -1.5 * lo_s
    h_mat_safe, h_safe = box_polytope(lo_s, hi_s)
    h_mat_obs, h_obs = box_polytope(lo_o, hi_o)
    spec = EnvSpec(
        dt=f(dt),
        init_m=torch.zeros(6, dtype=dtype, device=dev),
        init_std=torch.full((6,), init_std, dtype=dtype, device=dev),
        u_min=f([-u_lim, -u_lim]),
        u_max=f([u_lim, u_lim]),
        plant_noise=torch.full((6,), plant_noise, dtype=dtype, device=dev),
        target=torch.zeros(6, dtype=dtype, device=dev),
        h_mat_safe=h_mat_safe,
        h_safe=h_safe,
        h_mat_obs=h_mat_obs,
        h_obs=h_obs,
        norm_x=hi_o,
        norm_u=f([u_lim, u_lim]),
    )
    return Env(dynamics=dynamics, spec=spec, name="quadrotor")
