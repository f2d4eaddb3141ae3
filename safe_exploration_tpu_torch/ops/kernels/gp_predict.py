"""Fused lane GP posterior — wrapper of ``csrc/gp_predict.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/gp_predict.py::
gp_predict_lanes_pallas``: the RBF posterior mean, variance and optionally
the mean Jacobian at L query lanes, for every output dim in one launch.

Two steps, as cem_score takes them: :func:`prepare_posterior` makes a
GP-SSM's posterior ready once per model (a :class:`LanePosterior`: the mask
folded into the weights, K^-1 transposed, ``z_scale`` folded into the
support rows and the lengthscales, the hyperparameters formed; a sparse
model's support rows are its m inducing inputs, its weights alpha and
Kuu^-1 - Sigma^-1, with no mask), and
:func:`gp_predict_prepared` evaluates it at lanes z in raw coordinates, so
the Jacobian needs no chain rule and the call does no masking and no
hyperparameter arithmetic. For output dim e and lane l:

    kv  = sf2 exp(-0.5 sum_j (x_j il_j - z_j il_j)^2)               (n, L)
    mu  = w_mean kv,  var = max(sf2 - kv . (w_var kv), floor)
    jac = (X^T (kv * w_mean) - z sum(kv * w_mean)) il^2             (d, L)

with il = 1 / ls and floor = max(8 eps(dtype) sf2, 1e-12).
:func:`gp_predict_lanes` keeps the raw-array form (masked weights,
log-hyperparameters, inputs already divided by any input scale): it
prepares from the arrays, then launches. :func:`posterior_plain` is the
arithmetic in plain PyTorch on the prepared fields; the launch takes it for
tensors on the CPU and runs the kernel for tensors on a CUDA device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from safe_exploration_tpu_torch.ops.kernels import _build
from safe_exploration_tpu_torch.ops.kernels._common import (
    INT,
    VP,
    check,
    is_f64,
    on_cuda,
    raise_on_error,
    stream_ptr,
)

__all__ = ["LanePosterior", "gp_of", "gp_pallas_supported", "gp_predict_lanes",
           "gp_predict_plain", "gp_predict_prepared", "posterior_hyper",
           "posterior_plain", "prepare_posterior"]

_ARGTYPES = (VP,) * 12 + (INT,) * 6 + (VP,)


def gp_of(ssm):
    """The GP state of a GP-SSM: the sparse model's ``sgp`` or the exact
    (or per-lane) model's ``gp``; each has ``kern_types``, ``params``,
    ``log_noise``, ``x`` and ``n_out``."""
    sgp = getattr(ssm, "sgp", None)
    return sgp if sgp is not None else ssm.gp


def _support(ssm):
    """(rows, w_mean, w_var, state) of a model the kernel covers: a sparse
    GP-SSM's (known by its ``sgp``) inducing rows and unmasked weights, or
    an exact GP-SSM's (its ``gp``) buffer and masked weights. The models
    package builds on this one, so it is not imported here."""
    sgp = getattr(ssm, "sgp", None)
    if sgp is not None:
        return sgp.z, sgp.alpha, sgp.vmat, sgp
    gp = ssm.gp
    mask = gp.mask
    return (gp.x, gp.beta * mask[None],
            gp.kinv * (mask[None, :, None] * mask[None, None, :]), gp)


def gp_pallas_supported(ssm) -> bool:
    """Whether this kernel covers the model: one shared exact GP-SSM (known
    by its padded GP ``ssm.gp`` with a 2-D buffer) or a shared sparse one
    (its ``sgp``, a 2-D inducing set), with the all-RBF menu at f32
    precision. Per-lane and stacked models (a 3-D buffer) keep the plain
    form, as in the JAX package."""
    sgp = getattr(ssm, "sgp", None)
    gp = sgp if sgp is not None else getattr(ssm, "gp", None)
    if gp is None:
        return False
    rows = gp.x if sgp is None else gp.z
    return (rows.ndim == 2 and getattr(gp, "precision", "f32") == "f32"
            and all(kt == "rbf" for kt in gp.kern_types))


def posterior_hyper(inv_ls: torch.Tensor, log_sf: torch.Tensor):
    """(inv_ls, inv_ls^2, sf2, floor) of the kernels from the inverse
    lengthscales (e, d) and the log signal stds (e,)."""
    sf2 = torch.exp(2.0 * log_sf)
    floor = torch.clamp(8.0 * torch.finfo(sf2.dtype).eps * sf2, min=1e-12)
    return inv_ls, inv_ls * inv_ls, sf2, floor


class LanePosterior(NamedTuple):
    """A GP posterior made ready for the lane kernels (gp_predict and
    cem_score), once per model: the support rows in raw coordinates ``x``
    (n, d) and over each output dim's lengthscales ``x_il`` (e, n, d), the
    masked weights ``w_mean`` (e, n) and ``w_var_t`` (e, n, n) (K^-1 masked
    and transposed, so a row of the kernels' product tile is contiguous),
    and ``hyper`` = (inv_ls, inv_ls^2 (e, d), sf2, floor (e,)) of
    :func:`posterior_hyper`."""

    x: torch.Tensor
    x_il: torch.Tensor
    w_mean: torch.Tensor
    w_var_t: torch.Tensor
    hyper: tuple


def _lane_posterior(x, w_mean, w_var, inv_ls, log_sf, kw) -> LanePosterior:
    hyper = tuple(h.to(**kw).contiguous()
                  for h in posterior_hyper(inv_ls, log_sf))
    x = x.to(**kw).contiguous()
    return LanePosterior(
        x=x, x_il=(x[None] * hyper[0][:, None, :]).contiguous(),
        w_mean=w_mean.to(**kw).contiguous(),
        w_var_t=w_var.transpose(-1, -2).to(**kw).contiguous(), hyper=hyper)


def prepare_posterior(ssm, dtype=None) -> LanePosterior:
    """:class:`LanePosterior` of an exact or sparse GP-SSM on its device
    (``z_scale`` folded into the rows and lengthscales), in ``dtype``
    (default the model's)."""
    prepare_posterior.calls += 1
    x, w_mean, w_var, gp = _support(ssm)
    inv_ls = torch.exp(-torch.stack([p["log_lengthscales"] for p in gp.params]))
    kw = {"dtype": dtype or x.dtype, "device": x.device}
    if ssm.z_scale is not None:
        inv_ls = inv_ls / ssm.z_scale[None, :]
        x = x * ssm.z_scale[None, :]
    return _lane_posterior(
        x, w_mean, w_var, inv_ls,
        torch.stack([p["log_sf"] for p in gp.params]), kw)


prepare_posterior.calls = 0


def posterior_plain(post: LanePosterior, zz: torch.Tensor, *,
                    want_jac: bool):
    """The kernel's arithmetic on a prepared posterior at zz (d, L) ->
    (mu (e, L), var (e, L)[, jac (e, d, L)])."""
    inv_ls, inv_ls2, sf2, floor = post.hyper
    mus, vars_, jacs = [], [], []
    for e in range(post.w_mean.shape[0]):
        diff = post.x_il[e][:, :, None] - zz[None] * inv_ls[e][None, :, None]
        kv = sf2[e] * torch.exp(-0.5 * torch.sum(diff * diff, dim=1))  # (n, L)
        mus.append(post.w_mean[e] @ kv)
        quad = torch.sum(kv * (post.w_var_t[e].mT @ kv), dim=0)
        vars_.append(torch.maximum(sf2[e] - quad, floor[e]))
        if want_jac:
            wj = kv * post.w_mean[e][:, None]
            jacs.append((post.x.T @ wj - zz * torch.sum(wj, dim=0)) *
                        inv_ls2[e][:, None])
    out = (torch.stack(mus), torch.stack(vars_))
    return out + (torch.stack(jacs),) if want_jac else out


def _from_arrays(x, w_mean, w_var, log_ls, log_sf) -> LanePosterior:
    """:class:`LanePosterior` from raw arrays (no input scale)."""
    n, d = x.shape
    e = w_mean.shape[0]
    if w_mean.shape != (e, n) or w_var.shape != (e, n, n) or \
            log_ls.shape != (e, d) or log_sf.shape != (e,):
        raise ValueError(
            f"gp_predict_lanes: shapes x {tuple(x.shape)}, w_mean "
            f"{tuple(w_mean.shape)}, w_var {tuple(w_var.shape)}, log_ls "
            f"{tuple(log_ls.shape)}, log_sf {tuple(log_sf.shape)}")
    return _lane_posterior(x, w_mean, w_var, torch.exp(-log_ls), log_sf,
                           {"dtype": x.dtype, "device": x.device})


def gp_predict_plain(x, w_mean, w_var, log_ls, log_sf, zz, *, want_jac: bool):
    """Plain version of :func:`gp_predict_lanes` (same arguments)."""
    return posterior_plain(_from_arrays(x, w_mean, w_var, log_ls, log_sf), zz,
                           want_jac=want_jac)


def gp_predict_prepared(post: LanePosterior, zz: torch.Tensor, *,
                        want_jac: bool):
    """Posterior over L lanes from a :func:`prepare_posterior` result at
    zz (d, L) in raw coordinates -> (mu (e, L), var (e, L)[, jac (e, d,
    L)]); one launch on CUDA, :func:`posterior_plain` on the CPU."""
    if not on_cuda(post.x, zz):
        return posterior_plain(post, zz, want_jac=want_jac)
    (n, d), e, L = post.x.shape, post.w_mean.shape[0], zz.shape[1]
    if zz.shape[0] != d:
        raise ValueError(f"gp_predict_prepared: zz {tuple(zz.shape)} for "
                         f"inputs of width {d}")
    check("gp_predict_prepared", post.x, post.x_il, post.w_mean,
          post.w_var_t, *post.hyper, zz)
    kw = {"dtype": zz.dtype, "device": zz.device}
    mu, var = torch.empty((e, L), **kw), torch.empty((e, L), **kw)
    jac = torch.empty((e, d, L) if want_jac else (1,), **kw)
    fn = _build.load("gp_predict", "gp_predict_prepared", _ARGTYPES)
    with torch.cuda.device(zz.device):
        code = fn(post.x.data_ptr(), post.x_il.data_ptr(),
                  post.w_mean.data_ptr(), post.w_var_t.data_ptr(),
                  *(t.data_ptr() for t in post.hyper), zz.data_ptr(),
                  mu.data_ptr(), var.data_ptr(), jac.data_ptr(), n, d, e, L,
                  int(want_jac), is_f64(zz), stream_ptr(zz))
    raise_on_error("gp_predict_prepared", code)
    gp_predict_prepared.launches += 1
    return (mu, var, jac) if want_jac else (mu, var)


gp_predict_prepared.launches = 0


def gp_predict_lanes(x: torch.Tensor, w_mean: torch.Tensor,
                     w_var: torch.Tensor, log_ls: torch.Tensor,
                     log_sf: torch.Tensor, zz: torch.Tensor, *,
                     want_jac: bool):
    """Posterior over L lanes from raw arrays: x (n, d) support rows,
    w_mean (e, n) and w_var (e, n, n) masked weights, log_ls (e, d), log_sf
    (e,), zz (d, L) -> (mu (e, L), var (e, L)[, jac (e, d, L)]); prepares,
    then :func:`gp_predict_prepared` (one launch on CUDA)."""
    return gp_predict_prepared(_from_arrays(x, w_mean, w_var, log_ls, log_sf),
                               zz.contiguous(), want_jac=want_jac)
