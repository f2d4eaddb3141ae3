"""Sparse (inducing-point) GP regression — port of
``safe_exploration_tpu/models/sparse_gp.py``, the large-N tier (BASELINE
config 4).

The Titsias/VFE (SGPR) posterior over m inducing inputs Z, shared by the
output dims:

    Sigma   = Kuu + sigma_n^-2 Kuf Kuf^T              (m x m)
    alpha   = sigma_n^-2 Sigma^-1 Kuf y               (m,)
    mean(z) = Kzu alpha
    var(z)  = Kzz - Kzu (Kuu^-1 - Sigma^-1) Kuz

built in the whitened form (:func:`_factors_from_whitened`), which stays
finite in f32 where factoring Sigma directly does not. A refit costs
O(N m^2), a prediction O(m^2): N = 10k points with m = 256 inside the MPC
loop. Masked padding works as in the exact GP: masked columns of Kuf are
zeroed, so they add nothing to either contraction.

The factorizations are the library's (``torch.linalg``), as the JAX
package's are ``jnp.linalg``: the fit differentiates through them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from safe_exploration_tpu_torch.models.gp import (
    _theta_from_leaves,
    _theta_leaves,
    adam_fit,
    cholesky_or_nan,
    ring_write,
)
from safe_exploration_tpu_torch.models.kernels import (
    gram,
    init_kernel_params,
    kernel_diag,
    weighted_mean_jac,
)

__all__ = ["SparseGP", "SparseGPSSM", "make_sparse_gp_ssm", "sparse_gp_init",
           "sparse_gp_refit", "sparse_gp_update_data", "sparse_gp_predict",
           "sparse_gp_predict_mean_jac", "sparse_gp_predict_full_cov",
           "sparse_gp_elbo", "sparse_gp_fit"]

_JITTER = 1e-6


@dataclasses.dataclass(frozen=True)
class SparseGP:
    """Inducing-point multi-output GP state."""

    kern_types: tuple
    z: torch.Tensor          # (m, d_in) inducing inputs (shared by the dims)
    x: torch.Tensor          # (n_max, d_in) padded training inputs
    y: torch.Tensor          # (n_max, e)
    mask: torch.Tensor       # (n_max,)
    params: tuple            # per-dim kernel param dicts
    log_noise: torch.Tensor  # (e,)
    luu: torch.Tensor        # (e, m, m) chol(Kuu + jitter)
    lsig: torch.Tensor       # (e, m, m) chol(Sigma)
    alpha: torch.Tensor      # (e, m) predictive-mean weights
    vmat: torch.Tensor       # (e, m, m) Kuu^-1 - Sigma^-1
    head: int                # ring-buffer write pointer

    @property
    def n_max(self) -> int:
        return self.x.shape[0]

    @property
    def n_inducing(self) -> int:
        return self.z.shape[0]

    @property
    def n_out(self) -> int:
        return self.y.shape[1]

    @property
    def n_points(self) -> torch.Tensor:
        return torch.sum(self.mask).to(torch.int32)

    def replace(self, **changes) -> "SparseGP":
        return dataclasses.replace(self, **changes)


def _tri(a, b, *, upper: bool = False):
    return torch.linalg.solve_triangular(a, b, upper=upper)


def _factors_from_whitened(luu, aat, ayw):
    """(lsig, alpha, vmat) from the whitened data contractions aat = A A^T
    and ayw = A y / sigma_n, A = Luu^-1 Kuf / sigma_n. With B = I + A A^T:
    lsig = Luu chol(B), alpha = Luu^-T B^-1 ayw and vmat = Li^T Li - C^T C
    with Li = Luu^-1, C = chol(B)^-1 Li. B's eigenvalues are >= 1, so its
    Cholesky meets no negative pivot whatever N (the JAX package's
    docstring has the f32 failure this avoids)."""
    m = luu.shape[-1]
    eye = torch.eye(m, dtype=luu.dtype, device=luu.device)
    lb = cholesky_or_nan(eye + 0.5 * (aat + aat.mT))
    lsig = luu @ lb
    w = _tri(lb, ayw[:, None])
    v = _tri(lb.mT, w, upper=True)
    alpha = _tri(luu.mT, v, upper=True)[:, 0]
    li = _tri(luu, eye)
    c = _tri(lb, li)
    return lsig, alpha, li.mT @ li - c.mT @ c


def _kuu_jitter(kuu: torch.Tensor) -> torch.Tensor:
    """Cholesky jitter for Kuu at the dtype's rounding floor: max(1e-6,
    12 eps tr Kuu) (f32 rounding of the Gram moves eigenvalues by ~eps
    tr Kuu, which a fixed 1e-6 does not cover at m 256)."""
    eps = torch.finfo(kuu.dtype).eps
    return torch.maximum(torch.tensor(_JITTER, dtype=kuu.dtype,
                                      device=kuu.device),
                         12.0 * eps * torch.trace(kuu))


def _kuu_chol(kt, params, z):
    m = z.shape[0]
    kuu0 = gram(kt, params, z, z)
    eye = torch.eye(m, dtype=z.dtype, device=z.device)
    return cholesky_or_nan(kuu0 + _kuu_jitter(kuu0) * eye)


def _factors_dim(kt, params, z, x, mask, y_d, noise_var):
    """(luu, lsig, alpha, vmat) of one output dim."""
    luu = _kuu_chol(kt, params, z)
    kuf = gram(kt, params, z, x) * mask[None, :]
    sn = torch.sqrt(noise_var)
    a = _tri(luu, kuf) / sn
    lsig, alpha, vmat = _factors_from_whitened(luu, a @ a.mT,
                                               a @ (mask * y_d) / sn)
    return luu, lsig, alpha, vmat


def sparse_gp_refit(sgp: SparseGP) -> SparseGP:
    """Rebuild (luu, lsig, alpha, vmat) for the current data and
    hyperparameters."""
    parts = [
        _factors_dim(sgp.kern_types[d], sgp.params[d], sgp.z, sgp.x,
                     sgp.mask, sgp.y[:, d],
                     torch.exp(2.0 * sgp.log_noise[d]) + _JITTER)
        for d in range(sgp.n_out)]
    luu, lsig, alpha, vmat = (torch.stack(f) for f in zip(*parts))
    return sgp.replace(luu=luu, lsig=lsig, alpha=alpha, vmat=vmat)


def sparse_gp_init(kern_types: tuple, x: torch.Tensor, y: torch.Tensor, *,
                   n_max: int, n_inducing: int, log_noise=-2.3,
                   z: torch.Tensor | None = None,
                   params: tuple | None = None) -> SparseGP:
    """Build a sparse GP on the device and dtype of ``x``; the inducing
    inputs default to an even subsample of the data spread by
    1e-2 sin(i j) (with fewer points than m the subsample repeats points,
    and exact duplicates make Kuu singular)."""
    n, d_in = x.shape
    e = y.shape[1]
    kw = {"dtype": x.dtype, "device": x.device}
    if n > n_max:
        raise ValueError(f"initial data ({n}) exceeds n_max ({n_max})")
    if z is None:
        idx = torch.linspace(0, max(n - 1, 0), n_inducing,
                             dtype=torch.float64).to(torch.int64)
        z = x[idx.to(x.device)] + 1e-2 * torch.sin(
            torch.arange(n_inducing, **kw)[:, None]
            * torch.arange(1, d_in + 1, **kw)[None, :])
    xp = torch.zeros((n_max, d_in), **kw)
    xp[:n] = x
    yp = torch.zeros((n_max, e), **kw)
    yp[:n] = y
    mask = torch.zeros((n_max,), **kw)
    mask[:n] = 1.0
    if params is None:
        params = tuple(init_kernel_params(kt, d_in, **kw) for kt in kern_types)
    m = z.shape[0]
    sgp = SparseGP(
        kern_types=tuple(kern_types), z=z, x=xp, y=yp, mask=mask,
        params=params,
        log_noise=torch.as_tensor(log_noise, **kw).expand(e).clone(),
        luu=torch.zeros((e, m, m), **kw), lsig=torch.zeros((e, m, m), **kw),
        alpha=torch.zeros((e, m), **kw), vmat=torch.zeros((e, m, m), **kw),
        head=n)
    return sparse_gp_refit(sgp)


def sparse_gp_update_data(sgp: SparseGP, x_new: torch.Tensor,
                          y_new: torch.Tensor, *,
                          replace_old: bool = True) -> SparseGP:
    """Write a batch of transitions at the ring-buffer head (the exact GP's
    scatter, :func:`models.gp.ring_write`) and refit: O(N m^2)."""
    x, y, mask, head = ring_write(sgp, x_new, y_new, replace_old)
    return sparse_gp_refit(sgp.replace(x=x, y=y, mask=mask, head=head))


def _posterior(sgp: SparseGP, z2: torch.Tensor, with_jac: bool):
    """Per output dim: the mean, the floored latent variance and
    (``with_jac``) the closed-form mean Jacobian at the inputs z2 (k, d)."""
    eps = torch.finfo(z2.dtype).eps
    means, vars_, jacs = [], [], []
    for d in range(sgp.n_out):
        kt, params = sgp.kern_types[d], sgp.params[d]
        kzu = gram(kt, params, z2, sgp.z)                     # (k, m)
        means.append(kzu @ sgp.alpha[d])
        kzz = kernel_diag(kt, params, z2)
        floor = torch.clamp(8.0 * eps * kzz, min=1e-12)
        quad = torch.sum(kzu * (kzu @ sgp.vmat[d].mT), dim=-1)
        vars_.append(torch.maximum(kzz - quad, floor))
        if with_jac:
            jacs.append(weighted_mean_jac(kt, params, z2, sgp.z, kzu,
                                          sgp.alpha[d]))
    return means, vars_, jacs


def sparse_gp_predict(sgp: SparseGP, z: torch.Tensor):
    """Posterior mean and latent variance at inputs z (..., d_in) ->
    ((..., e), (..., e)); solve-free through alpha and vmat."""
    lead = z.shape[:-1]
    means, vars_, _ = _posterior(sgp, z.reshape(-1, z.shape[-1]), False)
    return (torch.stack(means, dim=-1).reshape(lead + (sgp.n_out,)),
            torch.stack(vars_, dim=-1).reshape(lead + (sgp.n_out,)))


def sparse_gp_predict_mean_jac(sgp: SparseGP, z: torch.Tensor):
    """Mean, latent variance and the closed-form mean Jacobian at inputs z
    (..., d_in) -> ((..., e), (..., e), (..., e, d_in)); the weighted sum
    runs over the inducing set."""
    lead = z.shape[:-1]
    means, vars_, jacs = _posterior(sgp, z.reshape(-1, z.shape[-1]), True)
    jac = torch.stack(jacs, dim=-2)
    return (torch.stack(means, dim=-1).reshape(lead + (sgp.n_out,)),
            torch.stack(vars_, dim=-1).reshape(lead + (sgp.n_out,)),
            jac.reshape(lead + jac.shape[-2:]))


def sparse_gp_predict_full_cov(sgp: SparseGP, z: torch.Tensor):
    """Joint posterior over a query batch z (k, d_in) -> (mean (k, e), cov
    (e, k, k)), cov = Kzz - Kzu vmat Kuz symmetrized, its diagonal floored
    as :func:`sparse_gp_predict`'s variance."""
    eps = torch.finfo(z.dtype).eps
    means, covs = [], []
    for d in range(sgp.n_out):
        kt, params = sgp.kern_types[d], sgp.params[d]
        kzu = gram(kt, params, z, sgp.z)
        means.append(kzu @ sgp.alpha[d])
        kzz = gram(kt, params, z, z)
        cov = kzz - kzu @ (sgp.vmat[d] @ kzu.mT)
        cov = 0.5 * (cov + cov.mT)
        diag = torch.diagonal(cov)
        floor = torch.clamp(8.0 * eps * torch.diagonal(kzz), min=1e-12)
        covs.append(cov + torch.diag(torch.maximum(diag, floor) - diag))
    return torch.stack(means, dim=-1), torch.stack(covs)


def sparse_gp_elbo(params: tuple, log_noise: torch.Tensor, sgp: SparseGP,
                   z: torch.Tensor | None = None) -> torch.Tensor:
    """Negative Titsias VFE bound (to minimize), summed over output dims:

    0.5 [N log(2 pi s2) + 2 sum log diag(LB) + y^T y / s2 - c^T c
         + (tr Kff - tr Qff) / s2]

    with A = Luu^-1 Kuf / s, B = I + A A^T, c = LB^-1 A y / s. ``z``
    overrides the stored inducing inputs, differentiably (the fit trains
    them)."""
    zi = sgp.z if z is None else z
    x, mask = sgp.x, sgp.mask
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    n_eff = torch.sum(mask)
    eye = torch.eye(zi.shape[0], dtype=x.dtype, device=x.device)
    for d in range(sgp.n_out):
        kt = sgp.kern_types[d]
        noise_var = torch.exp(2.0 * log_noise[d]) + _JITTER
        luu = _kuu_chol(kt, params[d], zi)
        kuf = gram(kt, params[d], zi, x) * mask[None, :]
        a = _tri(luu, kuf) / torch.sqrt(noise_var)
        lb = cholesky_or_nan(eye + a @ a.mT)
        yd = mask * sgp.y[:, d]
        c = _tri(lb, (a @ yd)[:, None])[:, 0] / torch.sqrt(noise_var)
        tr_kff = torch.sum(kernel_diag(kt, params[d], x) * mask)
        tr_qff = torch.sum(a * a) * noise_var
        total = total + 0.5 * (
            n_eff * torch.log(2.0 * math.pi * noise_var)
            + 2.0 * torch.sum(torch.log(torch.diagonal(lb)))
            + torch.dot(yd, yd) / noise_var
            - torch.dot(c, c)
            + (tr_kff - tr_qff) / noise_var)
    return total


def sparse_gp_fit(sgp: SparseGP, *, iters: int = 200, lr: float = 5e-2,
                  prior_strength: float = 0.5, opt_z: bool = True) -> SparseGP:
    """Adam on the negative VFE bound over the hyperparameters, the log
    noise and (``opt_z``) the inducing inputs, then a refit. The prior
    anchors the hyperparameters and the noise at their start, not Z: Z is
    a variational parameter, regularized by the bound itself."""
    leaves = _theta_leaves(sgp.params, sgp.log_noise)
    n_hyp = len(leaves)

    def loss(theta):
        params, log_noise = _theta_from_leaves(theta[:n_hyp], sgp.params)
        return sparse_gp_elbo(params, log_noise, sgp,
                              z=theta[n_hyp] if opt_z else None)

    theta = adam_fit(loss, leaves + ([sgp.z] if opt_z else []),
                     n_prior=n_hyp, iters=iters, lr=lr,
                     prior_strength=prior_strength)
    params, log_noise = _theta_from_leaves(theta[:n_hyp], sgp.params)
    new = sgp.replace(params=params, log_noise=log_noise)
    if opt_z:
        new = new.replace(z=theta[n_hyp])
    return sparse_gp_refit(new)


@dataclasses.dataclass(frozen=True)
class SparseGPSSM:
    """Sparse-GP residual-dynamics model: the SSM protocol
    (``predict_latent``, ``noise_var``, the Lipschitz constants) over a
    :class:`SparseGP`, so the reachability and the planners take it as
    they take the exact GP-SSM. ``z_scale`` as ``GPSSM.z_scale``."""

    sgp: SparseGP
    l_mu: torch.Tensor     # (n_s,)
    l_sigma: torch.Tensor  # (n_s,)
    z_scale: torch.Tensor | None = None

    def predict_latent(self, z: torch.Tensor):
        if self.z_scale is not None:
            z = z / self.z_scale
        return sparse_gp_predict(self.sgp, z)

    def noise_var(self) -> torch.Tensor:
        return torch.exp(2.0 * self.sgp.log_noise)

    def replace(self, **changes) -> "SparseGPSSM":
        return dataclasses.replace(self, **changes)


def make_sparse_gp_ssm(kern_types: tuple, x: torch.Tensor, u: torch.Tensor,
                       y: torch.Tensor, *, n_max: int, n_inducing: int,
                       l_mu: torch.Tensor, l_sigma: torch.Tensor,
                       log_noise: float = -2.3,
                       z_scale: torch.Tensor | None = None) -> SparseGPSSM:
    """Build a sparse-GP SSM from transitions (x, u) -> residual y on the
    device of ``x``."""
    from safe_exploration_tpu_torch.models.ssm import (
        _scale_consistent_params,
    )

    z = torch.cat([x, u], dim=-1)
    params = None
    if z_scale is not None:
        z = z / z_scale
        params = _scale_consistent_params(kern_types, z_scale)
    sgp = sparse_gp_init(kern_types, z, y, n_max=n_max,
                         n_inducing=n_inducing, log_noise=log_noise,
                         params=params)
    return SparseGPSSM(sgp=sgp, l_mu=l_mu, l_sigma=l_sigma, z_scale=z_scale)
