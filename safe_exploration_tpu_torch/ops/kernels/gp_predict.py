"""Fused lane GP posterior — wrapper of ``csrc/gp_predict.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/gp_predict.py::
gp_predict_lanes_pallas``: the RBF posterior mean, variance and optionally
the mean Jacobian at L query lanes, for every output dim in one launch.
The caller folds the validity mask into ``w_mean`` / ``w_var`` and passes
inputs already divided by any input scale:

    kv  = sf2 exp(-0.5 sum_j (x_j / ls_j - z_j / ls_j)^2)            (n, L)
    mu  = w_mean kv,  var = max(sf2 - kv . (w_var kv), floor)
    jac = (X^T (kv * w_mean) - z sum(kv * w_mean)) / ls^2           (d, L)

with floor = max(8 eps(dtype) sf2, 1e-12). :func:`gp_predict_plain` is the
same arithmetic in plain PyTorch; the wrapper takes it for tensors on the
CPU and launches the kernel for tensors on a CUDA device.
"""

from __future__ import annotations

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

__all__ = ["gp_pallas_supported", "gp_predict_lanes", "gp_predict_plain",
           "posterior_plain", "posterior_hyper"]

_ARGTYPES = (VP,) * 11 + (INT,) * 6 + (VP,)


def gp_pallas_supported(ssm) -> bool:
    """Whether this kernel covers the model: an exact GP-SSM (the port's
    only kind, known by its padded GP ``ssm.gp``; the models package builds
    on this one, so it is not imported here) with the all-RBF menu at f32
    precision."""
    gp = getattr(ssm, "gp", None)
    return (gp is not None and gp.precision == "f32"
            and all(kt == "rbf" for kt in gp.kern_types))


def posterior_hyper(inv_ls: torch.Tensor, log_sf: torch.Tensor):
    """(inv_ls, inv_ls^2, sf2, floor) of the kernels from the inverse
    lengthscales (e, d) and the log signal stds (e,)."""
    sf2 = torch.exp(2.0 * log_sf)
    floor = torch.clamp(8.0 * torch.finfo(sf2.dtype).eps * sf2, min=1e-12)
    return inv_ls, inv_ls * inv_ls, sf2, floor


def posterior_plain(x, w_mean, w_var, inv_ls, inv_ls2, sf2, floor, zz,
                    want_jac: bool):
    """The kernel's arithmetic: x (n, d), w_mean (e, n), w_var (e, n, n),
    inv_ls / inv_ls2 (e, d), sf2 / floor (e,), zz (d, L) -> (mu (e, L),
    var (e, L)[, jac (e, d, L)])."""
    mus, vars_, jacs = [], [], []
    for e in range(w_mean.shape[0]):
        il = inv_ls[e][None, :, None]
        diff = x[:, :, None] * il - zz[None] * il               # (n, d, L)
        kv = sf2[e] * torch.exp(-0.5 * torch.sum(diff * diff, dim=1))
        mus.append(w_mean[e] @ kv)
        quad = torch.sum(kv * (w_var[e] @ kv), dim=0)
        vars_.append(torch.maximum(sf2[e] - quad, floor[e]))
        if want_jac:
            wj = kv * w_mean[e][:, None]
            jacs.append((x.T @ wj - zz * torch.sum(wj, dim=0)) *
                        inv_ls2[e][:, None])
    out = (torch.stack(mus), torch.stack(vars_))
    return out + (torch.stack(jacs),) if want_jac else out


def gp_predict_plain(x, w_mean, w_var, log_ls, log_sf, zz, *, want_jac: bool):
    """Plain version of :func:`gp_predict_lanes` (same arguments)."""
    return posterior_plain(x, w_mean, w_var,
                           *posterior_hyper(torch.exp(-log_ls), log_sf), zz,
                           want_jac)


def gp_predict_lanes(x: torch.Tensor, w_mean: torch.Tensor,
                     w_var: torch.Tensor, log_ls: torch.Tensor,
                     log_sf: torch.Tensor, zz: torch.Tensor, *,
                     want_jac: bool):
    """Posterior over L lanes: x (n, d) support rows, w_mean (e, n) and
    w_var (e, n, n) masked weights, log_ls (e, d), log_sf (e,), zz (d, L)
    -> (mu (e, L), var (e, L)[, jac (e, d, L)]); one launch on CUDA."""
    if not on_cuda(x, w_mean, w_var, log_ls, log_sf, zz):
        return gp_predict_plain(x, w_mean, w_var, log_ls, log_sf, zz,
                                want_jac=want_jac)
    n, d = x.shape
    e, L = w_mean.shape[0], zz.shape[1]
    if w_mean.shape != (e, n) or w_var.shape != (e, n, n) or \
            log_ls.shape != (e, d) or log_sf.shape != (e,) or zz.shape[0] != d:
        raise ValueError(
            f"gp_predict_lanes: shapes x {tuple(x.shape)}, w_mean "
            f"{tuple(w_mean.shape)}, w_var {tuple(w_var.shape)}, log_ls "
            f"{tuple(log_ls.shape)}, log_sf {tuple(log_sf.shape)}, zz "
            f"{tuple(zz.shape)}")
    hyper = [t.contiguous()
             for t in posterior_hyper(torch.exp(-log_ls), log_sf)]
    check("gp_predict_lanes", x, w_mean, w_var, zz, *hyper)
    kw = {"dtype": x.dtype, "device": x.device}
    mu, var = torch.empty((e, L), **kw), torch.empty((e, L), **kw)
    jac = torch.empty((e, d, L) if want_jac else (1,), **kw)
    fn = _build.load("gp_predict", "gp_predict_lanes", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), w_mean.data_ptr(), w_var.data_ptr(),
                  *(t.data_ptr() for t in hyper), zz.data_ptr(),
                  mu.data_ptr(), var.data_ptr(), jac.data_ptr(), n, d, e, L,
                  int(want_jac), is_f64(x), stream_ptr(x))
    raise_on_error("gp_predict_lanes", code)
    gp_predict_lanes.launches += 1
    return (mu, var, jac) if want_jac else (mu, var)


gp_predict_lanes.launches = 0
