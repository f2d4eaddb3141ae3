"""Cart-pole — port of ``safe_exploration_tpu/envs/cartpole.py`` (BASELINE
config 2).

n_s = 4 (cart position p, cart velocity v, pole angle theta from upright,
angular velocity omega), n_u = 1 horizontal force, rail-bounded safe set.
Frictionless cart-pole with the pole as a point mass:

    (M + m) p_dd + m l (theta_dd cos - theta_d^2 sin) = u - b v
    l theta_dd + p_dd cos(theta) = g sin(theta)

with the 2x2 mass matrix solved in closed form.
"""

from __future__ import annotations

import torch

from safe_exploration_tpu_torch import resolve_device
from safe_exploration_tpu_torch.envs.base import Env, EnvSpec, box_polytope

__all__ = ["make_cartpole"]


def make_cartpole(
    *,
    dt: float = 0.1,
    cart_mass: float = 0.5,
    pole_mass: float = 0.2,
    length: float = 0.5,
    damping: float = 0.1,
    gravity: float = 9.81,
    u_lim: float = 5.0,
    rail_safe: float = 0.6,
    v_safe: float = 1.0,
    theta_safe: float = 0.25,
    omega_safe: float = 1.0,
    plant_noise: float = 1e-3,
    init_std: float = 0.005,
    dtype=torch.float32,
    device=None,
) -> Env:
    """Build the cart-pole environment (same defaults as the JAX package)."""
    dev = resolve_device(device)
    mt = cart_mass + pole_mass

    def dynamics(x, u):
        v, theta, omega = x[..., 1], x[..., 2], x[..., 3]
        sin_t = torch.sin(theta)
        cos_t = torch.cos(theta)
        force = u[..., 0] - damping * v
        denom = mt - pole_mass * cos_t * cos_t
        p_dd = (
            force + pole_mass * sin_t * (length * omega * omega
                                         - gravity * cos_t)
        ) / denom
        theta_dd = (gravity * sin_t - cos_t * p_dd) / length
        return torch.stack([v, p_dd, omega, theta_dd], dim=-1)

    def f(v):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    lo_s = f([-rail_safe, -v_safe, -theta_safe, -omega_safe])
    hi_s = -lo_s
    lo_o = 1.6 * lo_s
    hi_o = -lo_o
    h_mat_safe, h_safe = box_polytope(lo_s, hi_s)
    h_mat_obs, h_obs = box_polytope(lo_o, hi_o)
    spec = EnvSpec(
        dt=f(dt),
        init_m=torch.zeros(4, dtype=dtype, device=dev),
        init_std=torch.full((4,), init_std, dtype=dtype, device=dev),
        u_min=f([-u_lim]),
        u_max=f([u_lim]),
        plant_noise=torch.full((4,), plant_noise, dtype=dtype, device=dev),
        target=torch.zeros(4, dtype=dtype, device=dev),
        h_mat_safe=h_mat_safe,
        h_safe=h_safe,
        h_mat_obs=h_mat_obs,
        h_obs=h_obs,
        norm_x=hi_o,
        norm_u=f([u_lim]),
    )
    return Env(dynamics=dynamics, spec=spec, name="cartpole")
