"""Carry a GP state-space model across frameworks as numpy arrays.

:func:`gpssm_from_numpy` builds a :class:`GPSSM` from the arrays of a model
fitted elsewhere (for example by the JAX package), without refitting, so
both sides evaluate the same posterior. :func:`gpssm_to_numpy` is the
inverse. Keys: ``x`` (n, d_in), ``y`` (n, e), ``mask`` (n,), ``params`` (a
sequence of e dicts of arrays, e.g. ``log_lengthscales`` (d_in,) and
``log_sf`` ()), ``log_noise`` (e,), ``chol`` / ``kinv`` (e, n, n), ``beta``
(e, n), ``head`` (), ``l_mu`` / ``l_sigma`` (n_s,), ``z_scale`` (d_in,) or
None.

:func:`sparse_gpssm_from_numpy` and :func:`sparse_gpssm_to_numpy` do the
same for a :class:`SparseGPSSM`, whose factors are ``luu`` / ``lsig`` /
``vmat`` (e, m, m) and ``alpha`` (e, m) over the inducing inputs ``z``
(m, d_in), in place of ``chol`` / ``beta`` / ``kinv``.

:func:`mc_dropout_ssm_from_numpy` and :func:`mc_dropout_ssm_to_numpy` carry
a :class:`McDropoutSSM`: ``n_s``, ``n_samples``, ``keep_prob`` (plain
values), ``weights`` (a sequence of (w, b) pairs), ``mask_u`` (per hidden
layer the S passes' dropout uniforms (S, width), in their own dtype: the
JAX package draws the plain variant's in f64 under x64), ``keep_logit``
(n_hidden,) or None, ``log_noise`` / ``l_mu`` / ``l_sigma`` (e,), ``x``
(n, d_in) raw inputs, ``y`` (n, e), ``mask`` (n,) and ``head`` ().
"""

from __future__ import annotations

import numpy as np
import torch

from safe_exploration_tpu_torch.models.gp import GP
from safe_exploration_tpu_torch.models.nn_ssm import McDropoutSSM
from safe_exploration_tpu_torch.models.sparse_gp import SparseGP, SparseGPSSM
from safe_exploration_tpu_torch.models.ssm import GPSSM

__all__ = ["gpssm_from_numpy", "gpssm_to_numpy", "sparse_gpssm_from_numpy",
           "sparse_gpssm_to_numpy", "mc_dropout_ssm_from_numpy",
           "mc_dropout_ssm_to_numpy"]

_TENSORS = ("x", "y", "mask", "log_noise", "chol", "beta", "kinv")
_SPARSE_TENSORS = ("z", "x", "y", "mask", "log_noise", "luu", "lsig",
                   "alpha", "vmat")


def _from_numpy(arrays, kern_types, device, dtype, state_cls, ssm_cls,
                tensors, field):
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    state = state_cls(
        kern_types=tuple(kern_types),
        params=tuple({k: t(v) for k, v in p.items()} for p in arrays["params"]),
        head=int(np.asarray(arrays["head"])),
        **{k: t(arrays[k]) for k in tensors},
    )
    z_scale = arrays.get("z_scale")
    return ssm_cls(**{field: state}, l_mu=t(arrays["l_mu"]),
                   l_sigma=t(arrays["l_sigma"]),
                   z_scale=None if z_scale is None else t(z_scale))


def _to_numpy(ssm, state, tensors) -> dict:
    def a(x):
        return x.detach().cpu().numpy()

    return {
        **{k: a(getattr(state, k)) for k in tensors},
        "params": [{k: a(v) for k, v in p.items()} for p in state.params],
        "head": np.asarray(state.head, np.int32),
        "l_mu": a(ssm.l_mu),
        "l_sigma": a(ssm.l_sigma),
        "z_scale": None if ssm.z_scale is None else a(ssm.z_scale),
    }


def gpssm_from_numpy(arrays: dict, kern_types: tuple, *, device,
                     dtype=torch.float64) -> GPSSM:
    return _from_numpy(arrays, kern_types, device, dtype, GP, GPSSM,
                       _TENSORS, "gp")


def gpssm_to_numpy(ssm: GPSSM) -> dict:
    return _to_numpy(ssm, ssm.gp, _TENSORS)


def sparse_gpssm_from_numpy(arrays: dict, kern_types: tuple, *, device,
                            dtype=torch.float64) -> SparseGPSSM:
    return _from_numpy(arrays, kern_types, device, dtype, SparseGP,
                       SparseGPSSM, _SPARSE_TENSORS, "sgp")


def sparse_gpssm_to_numpy(ssm: SparseGPSSM) -> dict:
    return _to_numpy(ssm, ssm.sgp, _SPARSE_TENSORS)


def mc_dropout_ssm_from_numpy(arrays: dict, *, device,
                              dtype=torch.float64) -> McDropoutSSM:
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    keep_logit = arrays.get("keep_logit")
    return McDropoutSSM(
        n_s=int(arrays["n_s"]), n_samples=int(arrays["n_samples"]),
        keep_prob=float(arrays["keep_prob"]),
        weights=tuple((t(w), t(b)) for w, b in arrays["weights"]),
        mask_u=tuple(torch.tensor(np.asarray(u), device=device)
                     for u in arrays["mask_u"]),
        keep_logit=None if keep_logit is None else t(keep_logit),
        head=int(np.asarray(arrays["head"])),
        **{k: t(arrays[k]) for k in ("log_noise", "l_mu", "l_sigma", "x",
                                     "y", "mask")})


def mc_dropout_ssm_to_numpy(ssm: McDropoutSSM) -> dict:
    def a(x):
        return x.detach().cpu().numpy()

    return {
        "n_s": ssm.n_s, "n_samples": ssm.n_samples,
        "keep_prob": ssm.keep_prob,
        "weights": [(a(w), a(b)) for w, b in ssm.weights],
        "mask_u": [a(u) for u in ssm.mask_u],
        "keep_logit": None if ssm.keep_logit is None else a(ssm.keep_logit),
        "head": np.asarray(ssm.head, np.int32),
        **{k: a(getattr(ssm, k)) for k in ("log_noise", "l_mu", "l_sigma",
                                           "x", "y", "mask")},
    }
