"""Multi-output GP regression — port of ``safe_exploration_tpu/models/gp.py``.

One independent scalar GP per output dim over a padded (n_max, d) training
buffer with a validity mask. Masked rows/cols of the Gram matrix are the
identity (the masked-identity trick of the JAX package), so the Cholesky is
defined for any mask and beta = K^-1 (m * y) is exactly zero on padding.

The refit (Gram -> Cholesky -> beta and K^-1) runs through the hand-written
CUDA kernels of :mod:`safe_exploration_tpu_torch.ops.kernels` on a CUDA
device and through their plain PyTorch versions on the CPU. It is never
differentiated, so the kernels need no backward. ``linv.T @ linv`` stays a
``torch.matmul``.
"""

from __future__ import annotations

import dataclasses

import torch

from safe_exploration_tpu_torch.models.kernels import (
    gram,
    init_kernel_params,
    kernel_diag,
)
from safe_exploration_tpu_torch.ops.kernels import (
    cholesky_blocked,
    rbf_gram_masked,
    trsm_lower,
)

__all__ = ["GP", "gp_init", "gp_refit", "gp_update_data",
           "gp_shrink_to_bucket", "gp_predict", "gp_predict_mean_jac"]

_JITTER = 1e-6


@dataclasses.dataclass(frozen=True)
class GP:
    """Padded multi-output GP state."""

    kern_types: tuple     # (e,) kernel type per output dim
    x: torch.Tensor       # (n_max, d_in) padded training inputs
    y: torch.Tensor       # (n_max, e) padded training targets
    mask: torch.Tensor    # (n_max,) 1.0 where valid
    params: tuple         # per-dim kernel param dicts, length e
    log_noise: torch.Tensor  # (e,) log observation-noise std
    chol: torch.Tensor    # (e, n_max, n_max) lower Cholesky of masked K
    beta: torch.Tensor    # (e, n_max) K^-1 (mask * y_d)
    kinv: torch.Tensor    # (e, n_max, n_max) K^-1
    head: int             # ring-buffer write pointer
    precision: str = "f32"

    @property
    def n_max(self) -> int:
        return self.x.shape[0]

    @property
    def n_out(self) -> int:
        return self.y.shape[1]

    def replace(self, **changes) -> "GP":
        return dataclasses.replace(self, **changes)


def _masked_gram(kern_type: str, params: dict, x: torch.Tensor,
                 mask: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    """Gram matrix of one output dim with identity padding on masked entries
    (the per-dim plain form; the refit uses the batched kernel)."""
    k = gram(kern_type, params, x, x)
    k = k * (mask[:, None] * mask[None, :])
    diag = mask * (noise_var + _JITTER) + (1.0 - mask)
    return k + torch.diag(diag)


def _kinv_from_chol(l: torch.Tensor) -> torch.Tensor:
    """Explicit K^-1 = L^-T L^-1 from the lower factor(s) (..., n, n)."""
    n = l.shape[-1]
    eye = torch.eye(n, dtype=l.dtype, device=l.device).expand(l.shape)
    linv = trsm_lower(l, eye.contiguous())
    return linv.transpose(-1, -2) @ linv


def gp_refit(gp: GP) -> GP:
    """Recompute the posterior factors (chol, beta, kinv) for the current data
    and hyperparameters: one batched Gram, one batched Cholesky and three
    batched triangular solves over all output dims."""
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
    log_ls = torch.stack([p["log_lengthscales"] for p in gp.params])
    log_sf = torch.stack([p["log_sf"] for p in gp.params])
    noise_var = torch.exp(2.0 * gp.log_noise)
    k = rbf_gram_masked(gp.x, gp.mask, log_ls, log_sf, noise_var)
    l = cholesky_blocked(k)
    ym = (gp.mask[None, :] * gp.y.T).unsqueeze(-1).contiguous()  # (e, n, 1)
    z = trsm_lower(l, ym)
    beta = trsm_lower(l, z, transpose=True).squeeze(-1)
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
    return gp_refit(gp.replace(x=x, y=y, mask=mask, head=head))


def gp_shrink_to_bucket(gp: GP, *, min_bucket: int = 32) -> GP:
    """Slice the padded buffer to the smallest power-of-2 bucket holding the
    active points (factors are sliced, not recomputed: with identity padding
    they are block-diagonal across the active/padding boundary). Reads the
    mask on the host once. Requires a prefix layout, else returns ``gp``."""
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


def gp_predict(gp: GP, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and latent variance at inputs z (..., d_in) ->
    (mean (..., e), var (..., e)); solve-free through kinv, with the
    conditioning-aware variance floor of the JAX package."""
    lead = z.shape[:-1]
    z2 = z.reshape(-1, z.shape[-1])
    eps = torch.finfo(z.dtype).eps
    means, vars_ = [], []
    for d in range(gp.n_out):
        kt, params = gp.kern_types[d], gp.params[d]
        kv = gram(kt, params, z2, gp.x) * gp.mask            # (m, n_max)
        means.append(kv @ gp.beta[d])
        kzz = kernel_diag(kt, params, z2)
        floor = torch.clamp(8.0 * eps * kzz, min=1e-12)
        quad = torch.sum(kv * (kv @ gp.kinv[d].T), dim=-1)
        vars_.append(torch.maximum(kzz - quad, floor))
    mean = torch.stack(means, dim=-1).reshape(lead + (gp.n_out,))
    var = torch.stack(vars_, dim=-1).reshape(lead + (gp.n_out,))
    return mean, var


def gp_predict_mean_jac(gp: GP, z: torch.Tensor):
    """Posterior mean, latent variance and the closed-form mean Jacobian at
    inputs z (..., d_in) -> (mean (..., e), var (..., e), jac (..., e, d_in)).

    RBF: d/dz sum_i c_i k(z, x_i) = (sum_i c_i k_i x_i - z sum_i c_i k_i)
    / ls^2 with c = mask * beta (``kernels.weighted_mean_jac``)."""
    lead = z.shape[:-1]
    z2 = z.reshape(-1, z.shape[-1])
    mean, var = gp_predict(gp, z2)
    jacs = []
    for d in range(gp.n_out):
        kt, params = gp.kern_types[d], gp.params[d]
        w = gram(kt, params, z2, gp.x) * (gp.mask * gp.beta[d])   # (m, n_max)
        ls2 = torch.exp(2.0 * params["log_lengthscales"])
        jacs.append((w @ gp.x - torch.sum(w, dim=-1, keepdim=True) * z2) / ls2)
    jac = torch.stack(jacs, dim=-2)
    return (mean.reshape(lead + (gp.n_out,)), var.reshape(lead + (gp.n_out,)),
            jac.reshape(lead + jac.shape[-2:]))
