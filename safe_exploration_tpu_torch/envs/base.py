"""Environment substrate: continuous-control plants as plain PyTorch functions.

Port of ``safe_exploration_tpu/envs/base.py``. An environment is a dynamics
function ``(x, u) -> xdot`` plus an :class:`EnvSpec` of physical and safety
parameters. Dynamics functions index the LAST axis, so the same function
steps one state ``(n_s,)`` or a batch ``(B, n_s)``; ``env_step`` integrates
one control interval with fixed-step RK4 and adds process noise drawn from
an explicit ``torch.Generator`` or passed in as a tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from safe_exploration_tpu_torch.ops.linalg import expm_discretize

__all__ = ["EnvSpec", "Env", "env_reset", "env_step", "linearize_discretize",
           "rk4_step", "box_polytope", "normalize_state", "unnormalize_state",
           "normalize_control", "unnormalize_control"]

DynamicsFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Physical + safety parameters of a plant.

    ``h_mat_safe x <= h_safe`` is the terminal/safe polytope, ``h_mat_obs x
    <= h_obs`` the per-stage state constraints.
    """

    dt: torch.Tensor           # () control interval
    init_m: torch.Tensor       # (n_s,) mean initial state
    init_std: torch.Tensor     # (n_s,) std of initial state
    u_min: torch.Tensor        # (n_u,)
    u_max: torch.Tensor        # (n_u,)
    plant_noise: torch.Tensor  # (n_s,) std of additive process noise per step
    target: torch.Tensor       # (n_s,) task target state
    h_mat_safe: torch.Tensor   # (m_safe, n_s)
    h_safe: torch.Tensor       # (m_safe,)
    h_mat_obs: torch.Tensor    # (m_obs, n_s)
    h_obs: torch.Tensor        # (m_obs,)
    norm_x: torch.Tensor       # (n_s,) state normalization scales
    norm_u: torch.Tensor       # (n_u,) control normalization scales

    @property
    def n_s(self) -> int:
        return self.init_m.shape[0]

    @property
    def n_u(self) -> int:
        return self.u_min.shape[0]


class Env(NamedTuple):
    """An environment = dynamics function + parameter spec."""

    dynamics: DynamicsFn
    spec: EnvSpec
    name: str
    n_substeps: int = 8  # RK4 substeps per control interval


def rk4_step(dynamics: DynamicsFn, x: torch.Tensor, u: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    """One classical Runge-Kutta 4 step of size h (zero-order-hold control)."""
    k1 = dynamics(x, u)
    k2 = dynamics(x + 0.5 * h * k1, u)
    k3 = dynamics(x + 0.5 * h * k2, u)
    k4 = dynamics(x + h * k3, u)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def _integrate(env: Env, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    h = env.spec.dt / env.n_substeps
    for _ in range(env.n_substeps):
        x = rk4_step(env.dynamics, x, u, h)
    return x


def _std_normal(shape, like: torch.Tensor, generator, noise):
    if noise is not None:
        return noise.to(device=like.device, dtype=like.dtype)
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def env_reset(env: Env, *, batch: tuple = (), generator=None,
              noise: torch.Tensor | None = None) -> torch.Tensor:
    """Sample initial states ``init_m + init_std * N(0, 1)`` of shape
    ``batch + (n_s,)``; ``noise`` replaces the standard-normal draw."""
    s = env.spec
    z = _std_normal(tuple(batch) + (s.n_s,), s.init_m, generator, noise)
    return s.init_m + s.init_std * z


def env_step(env: Env, x: torch.Tensor, u: torch.Tensor, *, generator=None,
             noise: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the clipped control for one interval; return (u_applied, x_next).

    RK4 sub-stepped integration plus ``plant_noise * N(0, 1)``; the standard
    normal comes from ``generator`` or is given as ``noise`` (shape of x).
    ``x`` may be one state (n_s,) or a batch (B, n_s).
    """
    s = env.spec
    u_app = torch.clamp(u, s.u_min, s.u_max)
    x_next = _integrate(env, x, u_app)
    z = _std_normal(x.shape, x, generator, noise)
    return u_app, x_next + s.plant_noise * z


def linearize_discretize(
    env: Env, x_eq: torch.Tensor | None = None, u_eq: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Discrete-time prior (a, b): exact ZOH discretization of the Jacobian
    linearization at (x_eq, u_eq) (defaults: target state, zero control)."""
    s = env.spec
    if x_eq is None:
        x_eq = s.target
    if u_eq is None:
        u_eq = torch.zeros((s.n_u,), dtype=x_eq.dtype, device=x_eq.device)
    # reverse mode: forward mode (jacfwd) promotes a 0-d f32 tangent times a
    # Python float to f64 in this PyTorch
    a_c = torch.func.jacrev(lambda xx: env.dynamics(xx, u_eq))(x_eq)
    b_c = torch.func.jacrev(lambda uu: env.dynamics(x_eq, uu))(u_eq)
    return expm_discretize(a_c, b_c, s.dt)


def normalize_state(spec: EnvSpec, x: torch.Tensor) -> torch.Tensor:
    """States scaled to ~[-1, 1] by the spec's ``norm_x``."""
    return x / spec.norm_x


def unnormalize_state(spec: EnvSpec, x: torch.Tensor) -> torch.Tensor:
    return x * spec.norm_x


def normalize_control(spec: EnvSpec, u: torch.Tensor) -> torch.Tensor:
    return u / spec.norm_u


def unnormalize_control(spec: EnvSpec, u: torch.Tensor) -> torch.Tensor:
    return u * spec.norm_u


def box_polytope(lo: torch.Tensor, hi: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """H-representation of an axis-aligned box {lo <= x <= hi}: (H, h)."""
    n = lo.shape[0]
    eye = torch.eye(n, dtype=lo.dtype, device=lo.device)
    return torch.cat([eye, -eye], dim=0), torch.cat([hi, -lo], dim=0)
