"""GP state-space model — port of ``safe_exploration_tpu/models/ssm.py``.

A GP over inputs z = (x, u) modelling residual dynamics
Delta x = f(x, u) - prior(x, u), plus the Lipschitz constants the safety
tube needs. With ``z_scale`` the GP buffer holds normalized inputs and
``predict_latent`` divides raw inputs by the scales.

A **stacked** GPSSM (a stacked GP, ``l_mu`` / ``l_sigma`` (L, n_s),
``z_scale`` (L, d_in)) holds L independent models, as the JAX package's
vmapped one: :func:`ssm_fit`, :func:`ssm_probe_points`,
:func:`calibrate_lipschitz` and :func:`estimate_lipschitz` take it and
work on every lane at once (the Lipschitz Hessians nest the lane axis
around the probe axis under ``torch.func.vmap``); the predictions take it
at points with the lane axis in front ((L, ..., n_s)), and
:func:`ssm_append_point` appends one transition per lane in lockstep;
:func:`ssm_update` and :func:`ssm_bucketed` take one model only.

The entries dispatch over the model families the port carries: the exact
:class:`GPSSM` and the inducing-point
:class:`~safe_exploration_tpu_torch.models.sparse_gp.SparseGPSSM`
(its probe points are the inducing inputs; its bucketed view is itself).
"""

from __future__ import annotations

import dataclasses

import torch

from safe_exploration_tpu_torch.models import gp as gp_mod
from safe_exploration_tpu_torch.models.gp import GP
from safe_exploration_tpu_torch.models.kernels import init_kernel_params
from safe_exploration_tpu_torch.models.sparse_gp import (
    SparseGPSSM,
    sparse_gp_fit,
    sparse_gp_predict_mean_jac,
    sparse_gp_update_data,
)

__all__ = ["GPSSM", "make_gp_ssm", "ssm_update", "ssm_append_point",
           "ssm_bucketed", "ssm_lane", "is_stacked", "lane_front",
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
        return gp_mod.gp_predict(self.gp, _normalized(self, z))

    def noise_var(self) -> torch.Tensor:
        return torch.exp(2.0 * self.gp.log_noise)

    def replace(self, **changes) -> "GPSSM":
        return dataclasses.replace(self, **changes)


def is_stacked(ssm) -> bool:
    """Whether ``ssm`` is a stacked GPSSM (a leading lane axis)."""
    return isinstance(ssm, GPSSM) and ssm.gp.x.ndim == 3


def lane_front(ssm, v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane row ``v`` (L, k) of a stacked model shaped to broadcast
    against ``like`` (L, ..., k); ``v`` itself for one model."""
    if not is_stacked(ssm):
        return v
    if like.ndim < 2 or like.shape[0] != v.shape[0]:
        raise ValueError(
            f"a stacked model of {v.shape[0]} lanes takes points with its "
            f"lane axis in front, (lanes, ..., k), not {tuple(like.shape)} "
            "(appends: one point per lane); batch-last per-lane models are "
            "models/gp_lanes.py's")
    return v.reshape(v.shape[:1] + (1,) * (like.ndim - 2) + v.shape[1:])


def _normalized(ssm, z: torch.Tensor) -> torch.Tensor:
    """Raw inputs divided by the model's input scales (if any)."""
    if ssm.z_scale is None:
        return z
    return z / lane_front(ssm, ssm.z_scale, z)


def ssm_lane(ssm: GPSSM, i: int) -> GPSSM:
    """Lane ``i`` of a stacked GPSSM as one model (views, no copy)."""
    gp = ssm.gp
    return GPSSM(
        gp=gp.replace(
            x=gp.x[i], y=gp.y[i],
            mask=gp.mask[i] if gp.mask.ndim == 2 else gp.mask,
            params=tuple({k: v[i] for k, v in p.items()} for p in gp.params),
            log_noise=gp.log_noise[i], chol=gp.chol[i], beta=gp.beta[i],
            kinv=gp.kinv[i]),
        l_mu=ssm.l_mu[i], l_sigma=ssm.l_sigma[i],
        z_scale=None if ssm.z_scale is None else ssm.z_scale[i])


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


def ssm_predict(ssm, x: torch.Tensor, u: torch.Tensor):
    """Residual mean and variance at (state, action) pairs (..., n_s); a
    stacked model takes (L, ..., n_s), each lane against its own model."""
    return ssm.predict_latent(torch.cat([x, u], dim=-1))


def ssm_predict_jac(ssm, x: torch.Tensor, u: torch.Tensor):
    """Prediction and mean Jacobians split over state and control at
    (..., n_s), (..., n_u) -> (mu, var, jac_mu_x (..., n_s, n_s),
    jac_mu_u (..., n_s, n_u)); the Jacobian is the closed form of either
    GP family, taken in raw inputs (the chain rule of ``z_scale``
    applied). A stacked model takes (L, ..., n_s) as :func:`ssm_predict`."""
    _require_gp(ssm, "ssm_predict_jac")
    n_s = x.shape[-1]
    z = _normalized(ssm, torch.cat([x, u], dim=-1))
    if isinstance(ssm, SparseGPSSM):
        mu, var, jac = sparse_gp_predict_mean_jac(ssm.sgp, z)
    else:
        mu, var, jac = gp_mod.gp_predict_mean_jac(ssm.gp, z)
    if ssm.z_scale is not None:
        jac = jac / lane_front(ssm, ssm.z_scale, z)[..., None, :]
    return mu, var, jac[..., :n_s], jac[..., n_s:]


def ssm_noise_var(ssm) -> torch.Tensor:
    """Observation-noise variance per output dim; the tube adds it to the
    latent variance, so it covers plant process noise."""
    return ssm.noise_var()


def ssm_update(ssm, x: torch.Tensor, u: torch.Tensor, y: torch.Tensor,
               *, replace_old: bool = True):
    """Append observed transitions (batch) and refit the model."""
    _require_gp(ssm, "ssm_update")
    if isinstance(ssm, GPSSM):
        gp_mod._require_single(ssm.gp, "ssm_update")
    z = torch.cat([x, u], dim=-1)
    if ssm.z_scale is not None:
        z = z / ssm.z_scale
    if isinstance(ssm, SparseGPSSM):
        return ssm.replace(sgp=sparse_gp_update_data(
            ssm.sgp, z, y, replace_old=replace_old))
    return ssm.replace(
        gp=gp_mod.gp_update_data(ssm.gp, z, y, replace_old=replace_old)
    )


def ssm_append_point(ssm, x: torch.Tensor, u: torch.Tensor,
                     y: torch.Tensor) -> GPSSM:
    """O(n^2) append of ONE transition (:func:`gp_mod.gp_append_point`),
    or on a stacked model one per lane ((L, n_s), (L, n_u), (L, e)) in
    lockstep; owns the ``z_scale`` normalization, as :func:`ssm_update`."""
    if not isinstance(ssm, GPSSM):
        raise TypeError(
            "incremental appends are an exact-GP feature; use ssm_update for "
            f"{type(ssm).__name__}")
    z = _normalized(ssm, torch.cat([x, u], dim=-1))
    return ssm.replace(gp=gp_mod.gp_append_point(ssm.gp, z, y))


def ssm_bucketed(ssm):
    """Bucketed view of the model for the planner's hot loop (see
    :func:`gp_shrink_to_bucket`); a sparse model, whose posterior runs over
    its inducing set whatever the buffer holds, is its own view."""
    if isinstance(ssm, SparseGPSSM):
        return ssm
    return ssm.replace(gp=gp_mod.gp_shrink_to_bucket(ssm.gp))


def _require_gp(ssm, what: str) -> None:
    if not isinstance(ssm, (GPSSM, SparseGPSSM)):
        raise NotImplementedError(
            f"{what} of {type(ssm).__name__}: the port carries the exact and "
            "the sparse GP models (MC-dropout: ROADMAP Queue 1, item 12)")


def ssm_fit(ssm, *, iters: int = 200, lr: float = 5e-2):
    """Re-optimize the model's hyperparameters (:func:`gp_mod.gp_fit`; the
    sparse model's with its inducing inputs, ``sparse_gp_fit``) and
    refit."""
    _require_gp(ssm, "ssm_fit")
    if isinstance(ssm, SparseGPSSM):
        return ssm.replace(sgp=sparse_gp_fit(ssm.sgp, iters=iters, lr=lr))
    return ssm.replace(gp=gp_mod.gp_fit(ssm.gp, iters=iters, lr=lr))


def ssm_n_points(ssm) -> torch.Tensor:
    """Number of valid transitions the model holds (a 0-d int32 tensor)."""
    _require_gp(ssm, "ssm_n_points")
    return (ssm.sgp if isinstance(ssm, SparseGPSSM) else ssm.gp).n_points


def ssm_probe_points(ssm) -> torch.Tensor:
    """The (padded) training inputs in raw units: the default probe set of
    :func:`estimate_lipschitz`, (n_max, d_in) or per lane (L, n_max, d_in);
    of a sparse model its inducing inputs (m, d_in).
    ``predict_latent`` divides them by ``z_scale`` again; the pendulum's
    scales are powers of two, so that round trip gives the buffer's rows
    back exactly and a probe's distance to its own row is exactly 0."""
    _require_gp(ssm, "ssm_probe_points")
    rows = ssm.sgp.z if isinstance(ssm, SparseGPSSM) else ssm.gp.x
    if ssm.z_scale is None:
        return rows
    return rows * ssm.z_scale[..., None, :]


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
    (:func:`lipschitz_probe_set`; ``draws`` as there). A stacked model
    probes each lane's own buffer and the same region."""
    probes = ssm_probe_points(ssm)
    if n_region is None:
        n_region = 128 * probes.shape[-1]
    region = lipschitz_probe_set(spec, generator, n_region, draws=draws)
    region = region.to(probes.dtype).expand(
        probes.shape[:-2] + region.shape)
    return estimate_lipschitz(
        ssm, torch.cat([probes, region], dim=-2), factor=factor)


def _derivatives(ssm, z_points: torch.Tensor):
    """Hessians of the posterior mean (m, e, d, d) and gradients of the
    predictive std (m, e, d) at the points (m, d): ``torch.func``
    transforms vmapped over the points."""
    from torch.func import hessian, jacrev, vmap

    def mean(z):
        return ssm.predict_latent(z)[0]

    def std(z):
        return torch.sqrt(ssm.predict_latent(z)[1])

    return vmap(hessian(mean))(z_points), vmap(jacrev(std))(z_points)


# cuSOLVER's batched symmetric eigensolver refuses large batches (on an
# H100 with CUDA 12.8, 32,768 3 x 3 matrices failed where 8,192 passed);
# a fleet's calibration has 256 lanes x 512 probes x 2 dims of them
_EIG_CHUNK = 8192


def _eigvalsh(h: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.eigvalsh`` of (..., d, d), in chunks of at most
    ``_EIG_CHUNK`` matrices (each matrix's eigenvalues are its own)."""
    flat = h.reshape(-1, *h.shape[-2:])
    vals = [torch.linalg.eigvalsh(c) for c in flat.split(_EIG_CHUNK)]
    return torch.cat(vals).reshape(h.shape[:-1])


def _lane_derivatives(ssm, z_points: torch.Tensor):
    """:func:`_derivatives` of a stacked model at per-lane points (L, m, d):
    the lane axis vmapped around the point axis over the fields
    ``gp_predict`` reads."""
    from torch.func import vmap

    gp = ssm.gp

    def one(z, z_scale, x, mask, beta, kinv, params):
        lane = gp.replace(x=x, mask=mask, beta=beta, kinv=kinv, params=params)
        return _derivatives(ssm.replace(gp=lane, z_scale=z_scale), z)

    zs_dim = None if ssm.z_scale is None else 0
    mask_dim = 0 if gp.mask.ndim == 2 else None   # per lane or shared
    return vmap(one, in_dims=(0, zs_dim, 0, mask_dim, 0, 0, 0))(
        z_points, ssm.z_scale, gp.x, gp.mask, gp.beta, gp.kinv, gp.params)


def estimate_lipschitz(ssm, z_points: torch.Tensor, *, factor: float = 2.0,
                       l_mu_min: float = 1e-4, l_sigma_min: float = 1e-4):
    """Data-driven Lipschitz constants: per output dim ``l_mu = factor *
    max_z ||Hess mu(z)||_2`` and ``l_sigma = factor * max_z ||grad
    sigma(z)||_2`` over the probe points, floored. The Hessians and gradients
    are ``torch.func`` transforms vmapped over the points; the spectral norm
    of each d_in x d_in Hessian comes from ``eigvalsh``. A stacked model
    takes per-lane points (L, m, d) and gives (L, n_s) constants."""
    stacked = isinstance(ssm, GPSSM) and ssm.gp.x.ndim == 3
    derivs = _lane_derivatives if stacked else _derivatives
    hess, grads = derivs(ssm, z_points)            # (.., m, e, d, d), (.., m, e, d)
    hess_norms = torch.amax(torch.abs(_eigvalsh(hess)), dim=-1)
    grad_norms = torch.linalg.vector_norm(grads, dim=-1)
    l_mu = torch.clamp(factor * torch.amax(hess_norms, dim=-2), min=l_mu_min)
    l_sigma = torch.clamp(factor * torch.amax(grad_norms, dim=-2),
                          min=l_sigma_min)
    return ssm.replace(l_mu=l_mu, l_sigma=l_sigma)
