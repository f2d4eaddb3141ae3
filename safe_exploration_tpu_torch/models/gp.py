"""Multi-output GP regression — port of ``safe_exploration_tpu/models/gp.py``.

One independent scalar GP per output dim over a padded (n_max, d) training
buffer with a validity mask. Masked rows/cols of the Gram matrix are the
identity (the masked-identity trick of the JAX package), so the Cholesky is
defined for any mask and beta = K^-1 (m * y) is exactly zero on padding.

The refit (Gram -> Cholesky -> beta and L^-1) runs through the hand-written
CUDA kernels of :mod:`safe_exploration_tpu_torch.ops.kernels` on a CUDA
device and through their plain PyTorch versions on the CPU: the Cholesky is
``cholesky_blocked`` up to its ``MAX_N`` (1024) and ``cholesky_hbm`` above,
the split of the two Pallas kernels' ranges. It is never differentiated, so
the kernels need no backward. ``linv.T @ linv`` stays a ``torch.matmul``.
The hyperparameter fit (:func:`gp_nll`, :func:`gp_fit`) differentiates a
library Cholesky instead, as the JAX package does.

A **stacked** GP holds L independent models, one leading lane axis on every
tensor (``x`` (L, n_max, d_in), each hyperparameter (L, ...), ``chol``
(L, e, n_max, n_max), ...; ``head`` stays one shared int, and ``mask`` is
(n_max,) shared by lanes that append in lockstep, as the fleet's do, or
(L, n_max)): the JAX package's ``jax.vmap``-ed GP, written out.
:func:`gp_refit`, :func:`gp_nll` and :func:`gp_fit` take it as they take
one model: one Gram launch, one Cholesky, one PSD solve and one triangular
inverse over all L * e matrices, and a fit whose per-lane NLLs are summed
(lanes are independent, so each lane's gradient is its own; Adam is
elementwise). The entries that take one model only (:func:`gp_predict`,
:func:`gp_predict_mean_jac`, :func:`gp_update_data`,
:func:`gp_shrink_to_bucket`) raise on a stacked GP; per-lane prediction and
appends are ``models/gp_lanes.py``'s.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from safe_exploration_tpu_torch.models.kernels import (
    gram,
    init_kernel_params,
    kernel_diag,
    weighted_mean_jac,
)
from safe_exploration_tpu_torch.ops.kernels import (
    cholesky_blocked,
    cholesky_hbm,
    rbf_gram_masked,
    solve_psd,
    tri_inv_lower,
)
from safe_exploration_tpu_torch.ops.kernels.cholesky import MAX_N

__all__ = ["GP", "gp_init", "gp_refit", "gp_update_data", "gp_append_point",
           "gp_shrink_to_bucket", "gp_nll", "gp_fit", "gp_predict",
           "gp_predict_mean_jac", "refit_cholesky", "refit_inputs",
           "adam_fit", "cholesky_or_nan", "ring_write"]

_JITTER = 1e-6


@dataclasses.dataclass(frozen=True)
class GP:
    """Padded multi-output GP state, of one model or stacked (a leading
    lane axis on every tensor, see the module docstring)."""

    kern_types: tuple     # (e,) kernel type per output dim
    x: torch.Tensor       # (n_max, d_in) padded training inputs
    y: torch.Tensor       # (n_max, e) padded training targets
    mask: torch.Tensor    # (n_max,) 1.0 where valid (stacked: or (L, n_max))
    params: tuple         # per-dim kernel param dicts, length e
    log_noise: torch.Tensor  # (e,) log observation-noise std
    chol: torch.Tensor    # (e, n_max, n_max) lower Cholesky of masked K
    beta: torch.Tensor    # (e, n_max) K^-1 (mask * y_d)
    kinv: torch.Tensor    # (e, n_max, n_max) K^-1
    head: int             # ring-buffer write pointer
    precision: str = "f32"

    @property
    def n_max(self) -> int:
        return self.x.shape[-2]

    @property
    def n_out(self) -> int:
        return self.y.shape[-1]

    @property
    def n_points(self) -> torch.Tensor:
        """Valid points (per lane of a stacked GP with per-lane masks)."""
        return torch.sum(self.mask, dim=-1).to(torch.int32)

    def replace(self, **changes) -> "GP":
        return dataclasses.replace(self, **changes)


def _require_single(gp: GP, what: str) -> None:
    """Raise on a stacked GP for an entry that takes one model."""
    if gp.x.ndim != 2:
        raise ValueError(
            f"{what} takes one model, not a stacked GP (x "
            f"{tuple(gp.x.shape)}); per-lane models predict and append "
            "through models/gp_lanes.py")


def _require_lane_points(gp: GP, z: torch.Tensor, what: str) -> None:
    """Raise unless the points of a stacked GP carry its lane axis in
    front."""
    if z.ndim < 2 or z.shape[0] != gp.x.shape[0]:
        raise ValueError(
            f"{what} of a stacked GP ({gp.x.shape[0]} lanes) takes points "
            f"(lanes, ..., d_in), not {tuple(z.shape)}; batch-last "
            "per-lane models predict through models/gp_lanes.py")


def _masked_gram(kern_type: str, params: dict, x: torch.Tensor,
                 mask: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    """Gram matrix of one output dim with identity padding on masked entries
    (the per-dim plain form; the refit uses the batched kernel). Leading
    lane axes pass through."""
    k = gram(kern_type, params, x, x)
    k = k * (mask[..., :, None] * mask[..., None, :])
    diag = mask * (noise_var[..., None] + _JITTER) + (1.0 - mask)
    return k + torch.diag_embed(diag)


def _kinv_from_chol(l: torch.Tensor) -> torch.Tensor:
    """Explicit K^-1 = L^-T L^-1 from the lower factor(s) (..., n, n)."""
    linv = tri_inv_lower(l)
    return linv.transpose(-1, -2) @ linv


def refit_cholesky(n_max: int):
    """The refit's Cholesky for an ``n_max`` buffer: ``cholesky_blocked`` up
    to its ``MAX_N``, ``cholesky_hbm`` above."""
    return cholesky_blocked if n_max <= MAX_N else cholesky_hbm


def refit_inputs(gp: GP):
    """What :func:`gp_refit` hands its kernels: the batched Gram's arguments
    (the raw log-hyperparameters: the Gram forms the variances itself), the
    Cholesky (:func:`refit_cholesky`) and the masked targets (e, n, 1) —
    each with the lane axis in front for a stacked GP."""
    log_ls = torch.stack([p["log_lengthscales"] for p in gp.params], dim=-2)
    log_sf = torch.stack([p["log_sf"] for p in gp.params], dim=-1)
    ym = (gp.mask[..., None, :] * gp.y.mT).unsqueeze(-1).contiguous()
    return ((gp.x, gp.mask, log_ls, log_sf, gp.log_noise.contiguous()),
            refit_cholesky(gp.n_max), ym)


def gp_refit(gp: GP) -> GP:
    """Recompute the posterior factors (chol, beta, kinv) for the current data
    and hyperparameters: one batched Gram, one batched Cholesky (the blocked
    kernel up to n_max 1024, the left-looking one above), one PSD solve for
    beta and one triangular inverse for K^-1, each batched over all output
    dims (and all lanes of a stacked GP)."""
    if gp.precision == "ff":
        raise NotImplementedError(
            "precision='ff' (float-float refits) is not ported: on the H100 it "
            "becomes a native float64 refit (ROADMAP Queue 1, item 13)"
        )
    if set(gp.kern_types) != {"rbf"}:
        raise NotImplementedError(
            f"kern_types={gp.kern_types}: the port's refit covers the all-RBF "
            "menu (ROADMAP Queue 1, item 3)"
        )
    gram_args, cholesky, ym = refit_inputs(gp)
    l = cholesky(rbf_gram_masked(*gram_args))
    beta = solve_psd(l, ym).squeeze(-1)
    return gp.replace(chol=l, beta=beta, kinv=_kinv_from_chol(l))


def gp_init(kern_types: tuple, x: torch.Tensor, y: torch.Tensor, *, n_max: int,
            log_noise=-2.3, params: tuple | None = None,
            precision: str = "f32") -> GP:
    """Build a GP from initial data, padded to ``n_max`` rows, and refit.
    The device and dtype are those of ``x``."""
    n, d_in = x.shape
    e = y.shape[1]
    if len(kern_types) != e:
        raise ValueError("need one kernel type per output dim")
    if n > n_max:
        raise ValueError(f"initial data ({n}) exceeds n_max ({n_max})")
    kw = {"dtype": x.dtype, "device": x.device}
    xp = torch.zeros((n_max, d_in), **kw)
    xp[:n] = x
    yp = torch.zeros((n_max, e), **kw)
    yp[:n] = y
    mask = torch.zeros((n_max,), **kw)
    mask[:n] = 1.0
    if params is None:
        params = tuple(init_kernel_params(kt, d_in, **kw) for kt in kern_types)
    ln = torch.as_tensor(log_noise, **kw).expand(e).clone()
    gp = GP(
        kern_types=tuple(kern_types), x=xp, y=yp, mask=mask, params=params,
        log_noise=ln, chol=torch.zeros((e, n_max, n_max), **kw),
        beta=torch.zeros((e, n_max), **kw),
        kinv=torch.zeros((e, n_max, n_max), **kw), head=n,
        precision=precision,
    )
    return gp_refit(gp)


def gp_update_data(gp: GP, x_new: torch.Tensor, y_new: torch.Tensor, *,
                   replace_old: bool = True) -> GP:
    """Append a batch of transitions and refit; ring-buffer overwrite when
    full (``replace_old``), else the points past the buffer are dropped.

    The writes follow the JAX package's scatter, last write winning: without
    ``replace_old`` every dropped point writes the slot's old row back to the
    clamped last slot, so an overflowing batch leaves that slot as it was."""
    _require_single(gp, "gp_update_data")
    x, y, mask, head = ring_write(gp, x_new, y_new, replace_old)
    return gp_refit(gp.replace(x=x, y=y, mask=mask, head=head))


def ring_write(gp, x_new: torch.Tensor, y_new: torch.Tensor,
               replace_old: bool):
    """The buffers (x, y, mask) of a padded model (a GP or a sparse GP)
    with a batch written at its ring-buffer head, and the new head, by the
    JAX package's scatter (see :func:`gp_update_data`)."""
    k = x_new.shape[0]
    final = {}  # slot -> index into x_new, or None to keep the old row
    for i in range(k):
        p = gp.head + i
        if replace_old:
            final[p % gp.n_max] = i
        else:
            final[min(p, gp.n_max - 1)] = i if p < gp.n_max else None
    head = ((gp.head + k) % gp.n_max if replace_old
            else min(gp.head + k, gp.n_max))
    writes = [(p, i) for p, i in final.items() if i is not None]
    x, y, mask = gp.x.clone(), gp.y.clone(), gp.mask.clone()
    if writes:
        dst = torch.as_tensor([p for p, _ in writes], device=x.device)
        src = torch.as_tensor([i for _, i in writes], device=x.device)
        x[dst] = x_new[src]
        y[dst] = y_new[src]
        mask[dst] = 1.0
    return x, y, mask, head


def gp_append_point(gp: GP, x_new: torch.Tensor, y_new: torch.Tensor) -> GP:
    """O(n^2) append of ONE point by the bordered Cholesky extension (the
    JAX package's ``gp_append_point``): x_new (d_in,), y_new (e,), or on a
    stacked GP one point per lane, (L, d_in) and (L, e), appended in
    lockstep at the shared head.

    With identity padding K is block-diagonal across the mask, so
    activating slot ``head`` adds one row to each factor: l_row = L^-1 kv
    (kv the new point's cross-covariances masked by the OLD mask), l_nn =
    sqrt(max(k_nn + noise + jitter - |l_row|^2, jitter)); K^-1 gets the
    rank-1 block-inverse update; beta comes from two triangular solves on
    the maintained factor (not from K^-1). A full buffer is a no-op: the
    point is dropped and every factor stays as it was."""
    if gp.head >= gp.n_max:
        return gp
    stacked = gp.x.ndim == 3
    if stacked and (x_new.shape[0] != gp.x.shape[0] or x_new.ndim != 2):
        raise ValueError(
            f"gp_append_point on a stacked GP ({gp.x.shape[0]} lanes) takes "
            f"one point per lane, (lanes, d_in), not {tuple(x_new.shape)}")
    slot = gp.head
    x, y, mask = gp.x.clone(), gp.y.clone(), gp.mask.clone()
    x[..., slot, :] = x_new
    y[..., slot, :] = y_new
    mask[..., slot] = 1.0
    chols, betas, kinvs = [], [], []
    for d in range(gp.n_out):
        kt, params = gp.kern_types[d], gp.params[d]
        noise_var = torch.exp(2.0 * gp.log_noise[..., d])
        kv = gram(kt, params, x_new[..., None, :], x)[..., 0, :] * gp.mask
        chol = gp.chol[..., d, :, :]
        l_row = torch.linalg.solve_triangular(
            chol, kv[..., None], upper=False)[..., 0]
        knn = torch.exp(2.0 * params["log_sf"])
        schur = torch.clamp(
            knn + noise_var + _JITTER - torch.sum(l_row * l_row, dim=-1),
            min=_JITTER)
        new_l = chol.clone()
        new_l[..., slot, :] = l_row
        new_l[..., slot, slot] = torch.sqrt(schur)
        # K^-1 of the bordered matrix: with w = K_old^-1 kv (0 on every
        # inactive slot), [[K^-1 + w w^T / S, -w / S], [-w^T / S, 1 / S]]
        kinv = gp.kinv[..., d, :, :]
        w = (kinv @ kv[..., None])[..., 0]
        s = schur[..., None]
        new_kinv = kinv + w[..., :, None] * w[..., None, :] / s[..., None]
        slot_vec = -w / s
        slot_vec[..., slot] = 1.0 / schur
        new_kinv[..., slot, :] = slot_vec
        new_kinv[..., :, slot] = slot_vec
        yd = (mask * y[..., d])[..., None]
        z_half = torch.linalg.solve_triangular(new_l, yd, upper=False)
        betas.append(torch.linalg.solve_triangular(
            new_l.mT, z_half, upper=True)[..., 0])
        chols.append(new_l)
        kinvs.append(new_kinv)
    return gp.replace(x=x, y=y, mask=mask, chol=torch.stack(chols, dim=-3),
                      beta=torch.stack(betas, dim=-2),
                      kinv=torch.stack(kinvs, dim=-3), head=gp.head + 1)


def gp_shrink_to_bucket(gp: GP, *, min_bucket: int = 32) -> GP:
    """Slice the padded buffer to the smallest power-of-2 bucket holding the
    active points (factors are sliced, not recomputed: with identity padding
    they are block-diagonal across the active/padding boundary). Reads the
    mask on the host once. Requires a prefix layout, else returns ``gp``."""
    _require_single(gp, "gp_shrink_to_bucket")
    mask = gp.mask.cpu()
    n_pts = int(mask.sum())
    n_bucket = min_bucket
    while n_bucket < n_pts:
        n_bucket *= 2
    n_bucket = min(n_bucket, gp.n_max)
    if n_bucket >= gp.n_max:
        return gp
    if n_pts > 0 and float(mask[:n_pts].min()) < 1.0:
        return gp
    return gp.replace(
        x=gp.x[:n_bucket], y=gp.y[:n_bucket], mask=gp.mask[:n_bucket],
        chol=gp.chol[:, :n_bucket, :n_bucket], beta=gp.beta[:, :n_bucket],
        kinv=gp.kinv[:, :n_bucket, :n_bucket], head=min(gp.head, n_bucket),
    )


def cholesky_or_nan(k: torch.Tensor) -> torch.Tensor:
    """Differentiable library Cholesky of (..., n, n) whose failed
    factorizations give NaN, as JAX's do, instead of raising."""
    l, info = torch.linalg.cholesky_ex(k)
    nan = torch.tensor(float("nan"), dtype=k.dtype, device=k.device)
    return l + torch.where(info == 0, torch.zeros_like(nan),
                           nan)[..., None, None]


def gp_nll(params: tuple, log_noise: torch.Tensor, gp: GP) -> torch.Tensor:
    """Negative log marginal likelihood, summed over output dims; identity
    padding adds 0 to the quadratic form and the log-det. A stacked GP
    gives one value per lane (L,), as ``jax.vmap(gp_nll)``.

    Differentiable in ``params`` and ``log_noise`` through a library
    Cholesky (``cholesky_ex``), as the JAX package differentiates
    ``jnp.linalg.cholesky`` here and not a kernel. A failed factorization
    gives NaN, as JAX's does, instead of raising."""
    n_eff = torch.sum(gp.mask, dim=-1)
    k = torch.stack([
        _masked_gram(gp.kern_types[d], params[d], gp.x, gp.mask,
                     torch.exp(2.0 * log_noise[..., d]))
        for d in range(gp.n_out)], dim=-3)
    l = cholesky_or_nan(k)
    ym = (gp.mask[..., None, :] * gp.y.mT).unsqueeze(-1)
    z = torch.linalg.solve_triangular(l, ym, upper=False).squeeze(-1)
    per = 0.5 * torch.sum(z * z, dim=-1) + torch.sum(
        torch.log(torch.diagonal(l, dim1=-2, dim2=-1)), dim=-1)
    return (torch.sum(per, dim=-1)
            + gp.n_out * 0.5 * n_eff * math.log(2.0 * math.pi))


def _theta_leaves(params: tuple, log_noise: torch.Tensor) -> list:
    """The hyperparameters in the JAX package's pytree order: per output dim
    its dict's entries by sorted key, then the log noise."""
    return [p[k] for p in params for k in sorted(p)] + [log_noise]


def _theta_from_leaves(leaves: list, like: tuple):
    params, i = [], 0
    for p in like:
        params.append({k: leaves[i + j] for j, k in enumerate(sorted(p))})
        i += len(p)
    return tuple(params), leaves[i]


def gp_fit(gp: GP, *, iters: int = 200, lr: float = 5e-2,
           prior_strength: float = 0.5) -> GP:
    """Hyperparameter fit: ``iters`` Adam steps on the log-space NLL plus a
    weak Gaussian prior (``prior_strength``) centred at the current
    hyperparameters, then a refit.

    Adam is written out in optax's order of operations (moments, bias
    correction, ``-lr * mu_hat / (sqrt(nu_hat) + 1e-8)``) rather than taken
    from ``torch.optim``, so the two packages' fits agree to rounding.
    The loop never reads a value back to the host. A stacked GP is fitted
    lane by lane in one loop: the loss is the lanes' summed NLL, whose
    gradient in a lane's hyperparameters is that lane's own."""
    def loss(leaves):
        params, log_noise = _theta_from_leaves(leaves, gp.params)
        return torch.sum(gp_nll(params, log_noise, gp))

    theta = adam_fit(loss, _theta_leaves(gp.params, gp.log_noise),
                     n_prior=None, iters=iters, lr=lr,
                     prior_strength=prior_strength)
    params, log_noise = _theta_from_leaves(theta, gp.params)
    return gp_refit(gp.replace(params=params, log_noise=log_noise))


def adam_fit(loss, theta: list, *, n_prior: int | None, iters: int,
             lr: float, prior_strength: float) -> list:
    """``iters`` Adam steps on ``loss(leaves)`` plus ``prior_strength``
    times the squared distance of the first ``n_prior`` leaves (all when
    None) from their start, in optax's order of operations; returns the
    final leaves."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    ref = [t.detach() for t in theta]
    theta = [t.clone() for t in ref]
    mu = [torch.zeros_like(t) for t in theta]
    nu = [torch.zeros_like(t) for t in theta]
    for count in range(1, iters + 1):
        leaves = [t.requires_grad_(True) for t in theta]
        with torch.enable_grad():
            obj = loss(leaves)
            if prior_strength > 0.0:
                prior = None
                for t, t0 in list(zip(leaves, ref))[:n_prior]:
                    sq = torch.sum((t - t0) ** 2)
                    prior = sq if prior is None else prior + sq
                obj = obj + prior_strength * prior
            grads = torch.autograd.grad(obj, leaves)
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        new = []
        for i, (t, g) in enumerate(zip(theta, grads)):
            mu[i] = (1 - b1) * g + b1 * mu[i]
            nu[i] = (1 - b2) * g ** 2 + b2 * nu[i]
            step = (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + eps)
            new.append(t.detach() + -lr * step)
        theta = new
    return theta


def _posterior(gp: GP, z2: torch.Tensor, with_jac: bool):
    """Per output dim: the posterior mean, the floored latent variance and
    (``with_jac``) the closed-form mean Jacobian at the inputs z2 (m,
    d_in), or on a stacked GP (L, m, d_in) against each lane's own model,
    from one cross-covariance ``kv`` per dim."""
    stacked = gp.x.ndim == 3
    mask = gp.mask[..., None, :] if stacked else gp.mask
    eps = torch.finfo(z2.dtype).eps
    means, vars_, jacs = [], [], []
    for d in range(gp.n_out):
        kt, params = gp.kern_types[d], gp.params[d]
        kv = gram(kt, params, z2, gp.x) * mask               # (.., m, n_max)
        beta = gp.beta[..., d, :]
        means.append((kv @ beta[..., None])[..., 0] if stacked
                     else kv @ beta)
        kzz = kernel_diag(kt, params, z2)
        floor = torch.clamp(8.0 * eps * kzz, min=1e-12)
        quad = torch.sum(kv * (kv @ gp.kinv[..., d, :, :].mT), dim=-1)
        vars_.append(torch.maximum(kzz - quad, floor))
        if with_jac:
            # kv carries the mask, so the weights are beta's
            jacs.append(weighted_mean_jac(kt, params, z2, gp.x, kv,
                                          beta[..., None, :] if stacked
                                          else beta))
    return means, vars_, jacs


def _flat_points(gp: GP, z: torch.Tensor, what: str) -> torch.Tensor:
    """The points as the posterior takes them: (m, d_in), or on a stacked
    GP (L, m, d_in)."""
    if gp.x.ndim == 2:
        return z.reshape(-1, z.shape[-1])
    _require_lane_points(gp, z, what)
    return z.reshape(z.shape[0], -1, z.shape[-1])


def gp_predict(gp: GP, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and latent variance at inputs z (..., d_in) ->
    (mean (..., e), var (..., e)); solve-free through kinv, with the
    conditioning-aware variance floor of the JAX package. A stacked GP
    takes z (L, ..., d_in), each lane's points against its own model."""
    lead = z.shape[:-1]
    means, vars_, _ = _posterior(gp, _flat_points(gp, z, "gp_predict"),
                                 False)
    mean = torch.stack(means, dim=-1).reshape(lead + (gp.n_out,))
    var = torch.stack(vars_, dim=-1).reshape(lead + (gp.n_out,))
    return mean, var


def gp_predict_mean_jac(gp: GP, z: torch.Tensor):
    """Posterior mean, latent variance and the closed-form mean Jacobian at
    inputs z (..., d_in) -> (mean (..., e), var (..., e), jac (..., e, d_in))
    (:func:`kernels.weighted_mean_jac`), on the same
    cross-covariance as the mean and variance. A stacked GP takes z (L,
    ..., d_in), as :func:`gp_predict`."""
    lead = z.shape[:-1]
    means, vars_, jacs = _posterior(
        gp, _flat_points(gp, z, "gp_predict_mean_jac"), True)
    jac = torch.stack(jacs, dim=-2)
    return (torch.stack(means, dim=-1).reshape(lead + (gp.n_out,)),
            torch.stack(vars_, dim=-1).reshape(lead + (gp.n_out,)),
            jac.reshape(lead + jac.shape[-2:]))
