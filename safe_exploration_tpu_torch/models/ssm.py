"""GP state-space model — port of ``safe_exploration_tpu/models/ssm.py``.

A GP over inputs z = (x, u) modelling residual dynamics
Delta x = f(x, u) - prior(x, u), plus the Lipschitz constants the safety
tube needs. With ``z_scale`` the GP buffer holds normalized inputs and
``predict_latent`` divides raw inputs by the scales.
"""

from __future__ import annotations

import dataclasses

import torch

from safe_exploration_tpu_torch.models import gp as gp_mod
from safe_exploration_tpu_torch.models.gp import GP
from safe_exploration_tpu_torch.models.kernels import init_kernel_params

__all__ = ["GPSSM", "make_gp_ssm", "ssm_update", "ssm_bucketed",
           "ssm_predict", "ssm_predict_jac", "ssm_noise_var"]


@dataclasses.dataclass(frozen=True)
class GPSSM:
    """GP residual-dynamics model + Lipschitz constants l_mu / l_sigma of the
    posterior-mean gradient and of the predictive std, per output dim."""

    gp: GP
    l_mu: torch.Tensor     # (n_s,)
    l_sigma: torch.Tensor  # (n_s,)
    z_scale: torch.Tensor | None = None  # (d_in,) or None (identity)

    def predict_latent(self, z: torch.Tensor):
        if self.z_scale is not None:
            z = z / self.z_scale
        return gp_mod.gp_predict(self.gp, z)

    def noise_var(self) -> torch.Tensor:
        return torch.exp(2.0 * self.gp.log_noise)

    def replace(self, **changes) -> "GPSSM":
        return dataclasses.replace(self, **changes)


def _scale_consistent_params(kern_types: tuple, z_scale: torch.Tensor) -> tuple:
    """Initial hyperparameters for normalized inputs equivalent to unit-scale
    raw-input ones (ell_norm = 1 / z_scale)."""
    params = []
    for kt in kern_types:
        p = init_kernel_params(kt, z_scale.shape[0], dtype=z_scale.dtype,
                               device=z_scale.device)
        p = {**p, "log_lengthscales": p["log_lengthscales"] - torch.log(z_scale)}
        params.append(p)
    return tuple(params)


def make_gp_ssm(kern_types: tuple, x: torch.Tensor, u: torch.Tensor,
                y: torch.Tensor, *, n_max: int, l_mu: torch.Tensor,
                l_sigma: torch.Tensor, log_noise: float = -2.3,
                z_scale: torch.Tensor | None = None, precision: str = "f32",
                m_subset: int | None = None) -> GPSSM:
    """Build a GP-SSM from initial transitions (x_t, u_t) -> residual y_t on
    the device of ``x``."""
    if m_subset is not None and 0 < m_subset < x.shape[0]:
        idx = torch.linspace(0, x.shape[0] - 1, m_subset,
                             dtype=torch.float64).to(torch.int64)
        idx = idx.to(x.device)
        x, u, y = x[idx], u[idx], y[idx]
    z = torch.cat([x, u], dim=-1)
    params = None
    if z_scale is not None:
        z = z / z_scale
        params = _scale_consistent_params(kern_types, z_scale)
    gp = gp_mod.gp_init(kern_types, z, y, n_max=n_max, log_noise=log_noise,
                        precision=precision, params=params)
    return GPSSM(gp=gp, l_mu=l_mu, l_sigma=l_sigma, z_scale=z_scale)


def ssm_predict(ssm: GPSSM, x: torch.Tensor, u: torch.Tensor):
    """Residual mean and variance at (state, action) pairs (..., n_s)."""
    return ssm.predict_latent(torch.cat([x, u], dim=-1))


def ssm_predict_jac(ssm: GPSSM, x: torch.Tensor, u: torch.Tensor):
    """Prediction and mean Jacobians split over state and control at
    (..., n_s), (..., n_u) -> (mu, var, jac_mu_x (..., n_s, n_s),
    jac_mu_u (..., n_s, n_u)); the Jacobian is taken in raw inputs (the
    chain rule of ``z_scale`` applied)."""
    n_s = x.shape[-1]
    z = torch.cat([x, u], dim=-1)
    if ssm.z_scale is not None:
        z = z / ssm.z_scale
    mu, var, jac = gp_mod.gp_predict_mean_jac(ssm.gp, z)
    if ssm.z_scale is not None:
        jac = jac / ssm.z_scale
    return mu, var, jac[..., :n_s], jac[..., n_s:]


def ssm_noise_var(ssm: GPSSM) -> torch.Tensor:
    """Observation-noise variance per output dim; the tube adds it to the
    latent variance, so it covers plant process noise."""
    return ssm.noise_var()


def ssm_update(ssm: GPSSM, x: torch.Tensor, u: torch.Tensor, y: torch.Tensor,
               *, replace_old: bool = True) -> GPSSM:
    """Append observed transitions (batch) and refit the model."""
    z = torch.cat([x, u], dim=-1)
    if ssm.z_scale is not None:
        z = z / ssm.z_scale
    return ssm.replace(
        gp=gp_mod.gp_update_data(ssm.gp, z, y, replace_old=replace_old)
    )


def ssm_bucketed(ssm: GPSSM) -> GPSSM:
    """Bucketed view of the model for the planner's hot loop (see
    :func:`gp_shrink_to_bucket`)."""
    return ssm.replace(gp=gp_mod.gp_shrink_to_bucket(ssm.gp))
