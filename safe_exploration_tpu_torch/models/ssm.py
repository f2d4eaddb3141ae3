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
           "ssm_predict", "ssm_predict_jac", "ssm_noise_var", "ssm_fit",
           "ssm_n_points", "ssm_probe_points", "lipschitz_probe_set",
           "calibrate_lipschitz", "estimate_lipschitz"]


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


def _require_gp(ssm, what: str) -> None:
    if not isinstance(ssm, GPSSM):
        raise NotImplementedError(
            f"{what} of {type(ssm).__name__}: the port carries the exact GP "
            "model only (sparse GP: ROADMAP Queue 1, item 11; MC-dropout: "
            "item 12)")


def ssm_fit(ssm, *, iters: int = 200, lr: float = 5e-2):
    """Re-optimize the GP hyperparameters (:func:`gp_mod.gp_fit`) and
    refit."""
    _require_gp(ssm, "ssm_fit")
    return ssm.replace(gp=gp_mod.gp_fit(ssm.gp, iters=iters, lr=lr))


def ssm_n_points(ssm) -> torch.Tensor:
    """Number of valid transitions the model holds (a 0-d int32 tensor)."""
    _require_gp(ssm, "ssm_n_points")
    return ssm.gp.n_points


def ssm_probe_points(ssm) -> torch.Tensor:
    """The (padded) training inputs in raw units: the default probe set of
    :func:`estimate_lipschitz`."""
    _require_gp(ssm, "ssm_probe_points")
    return ssm.gp.x if ssm.z_scale is None else ssm.gp.x * ssm.z_scale


def lipschitz_probe_set(spec, generator: torch.Generator | None = None,
                        n_samples: int = 64, *, draws=None) -> torch.Tensor:
    """Probe inputs over the operating region: states uniform over the
    bounding box of the state polytope, controls uniform over the control
    box, (n_samples, n_s + n_u). ``draws`` = (ux (n, n_s), uu (n, n_u)),
    uniforms on [0, 1), replaces the draws of ``generator`` (``None``: a
    fresh generator seeded 0, as the JAX package uses PRNGKey(0))."""
    from safe_exploration_tpu_torch.solvers.static_exploration import (
        polytope_box_bounds,
    )

    lo, hi = polytope_box_bounds(spec.h_mat_obs, spec.h_obs)
    kw = {"dtype": spec.u_min.dtype, "device": spec.u_min.device}
    n_s, n_u = spec.h_mat_obs.shape[1], spec.u_min.shape[0]
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = tuple(torch.rand((n_samples, k), generator=generator,
                                 dtype=kw["dtype"], device=generator.device)
                      for k in (n_s, n_u))
    ux, uu = (torch.as_tensor(d).to(**kw) for d in draws)
    xs = ux * torch.as_tensor(hi - lo, **kw) + torch.as_tensor(lo, **kw)
    us = uu * (spec.u_max - spec.u_min) + spec.u_min
    return torch.cat([xs, us], dim=-1)


def calibrate_lipschitz(ssm, spec, generator: torch.Generator | None = None,
                        *, n_region: int | None = None, factor: float = 1.2,
                        draws=None):
    """Estimate l_mu / l_sigma over the training buffer plus ``n_region``
    (default 128 d_in) probes of the operating region
    (:func:`lipschitz_probe_set`; ``draws`` as there)."""
    probes = ssm_probe_points(ssm)
    if n_region is None:
        n_region = 128 * probes.shape[-1]
    region = lipschitz_probe_set(spec, generator, n_region, draws=draws)
    return estimate_lipschitz(
        ssm, torch.cat([probes, region.to(probes.dtype)], dim=0),
        factor=factor)


def estimate_lipschitz(ssm, z_points: torch.Tensor, *, factor: float = 2.0,
                       l_mu_min: float = 1e-4, l_sigma_min: float = 1e-4):
    """Data-driven Lipschitz constants: per output dim ``l_mu = factor *
    max_z ||Hess mu(z)||_2`` and ``l_sigma = factor * max_z ||grad
    sigma(z)||_2`` over the probe points, floored. The Hessians and gradients
    are ``torch.func`` transforms vmapped over the points; the spectral norm
    of each d_in x d_in Hessian comes from ``eigvalsh``."""
    from torch.func import hessian, jacrev, vmap

    def mean(z):
        return ssm.predict_latent(z)[0]

    def std(z):
        return torch.sqrt(ssm.predict_latent(z)[1])

    hess = vmap(hessian(mean))(z_points)                  # (m, e, d, d)
    grads = vmap(jacrev(std))(z_points)                   # (m, e, d)
    hess_norms = torch.amax(torch.abs(torch.linalg.eigvalsh(hess)), dim=-1)
    grad_norms = torch.linalg.vector_norm(grads, dim=-1)
    l_mu = torch.clamp(factor * torch.amax(hess_norms, dim=0), min=l_mu_min)
    l_sigma = torch.clamp(factor * torch.amax(grad_norms, dim=0),
                          min=l_sigma_min)
    return ssm.replace(l_mu=l_mu, l_sigma=l_sigma)
