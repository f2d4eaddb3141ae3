"""Carry a GP state-space model across frameworks as numpy arrays.

:func:`gpssm_from_numpy` builds a :class:`GPSSM` from the arrays of a model
fitted elsewhere (for example by the JAX package), without refitting, so
both sides evaluate the same posterior. :func:`gpssm_to_numpy` is the
inverse. Keys: ``x`` (n, d_in), ``y`` (n, e), ``mask`` (n,), ``params`` (a
sequence of e dicts of arrays, e.g. ``log_lengthscales`` (d_in,) and
``log_sf`` ()), ``log_noise`` (e,), ``chol`` / ``kinv`` (e, n, n), ``beta``
(e, n), ``head`` (), ``l_mu`` / ``l_sigma`` (n_s,), ``z_scale`` (d_in,) or
None.
"""

from __future__ import annotations

import numpy as np
import torch

from safe_exploration_tpu_torch.models.gp import GP
from safe_exploration_tpu_torch.models.ssm import GPSSM

__all__ = ["gpssm_from_numpy", "gpssm_to_numpy"]

_TENSORS = ("x", "y", "mask", "log_noise", "chol", "beta", "kinv")


def gpssm_from_numpy(arrays: dict, kern_types: tuple, *, device,
                     dtype=torch.float64) -> GPSSM:
    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    gp = GP(
        kern_types=tuple(kern_types),
        params=tuple({k: t(v) for k, v in p.items()} for p in arrays["params"]),
        head=int(np.asarray(arrays["head"])),
        **{k: t(arrays[k]) for k in _TENSORS},
    )
    z_scale = arrays.get("z_scale")
    return GPSSM(gp=gp, l_mu=t(arrays["l_mu"]), l_sigma=t(arrays["l_sigma"]),
                 z_scale=None if z_scale is None else t(z_scale))


def gpssm_to_numpy(ssm: GPSSM) -> dict:
    def a(x):
        return x.detach().cpu().numpy()

    gp = ssm.gp
    return {
        **{k: a(getattr(gp, k)) for k in _TENSORS},
        "params": [{k: a(v) for k, v in p.items()} for p in gp.params],
        "head": np.asarray(gp.head, np.int32),
        "l_mu": a(ssm.l_mu),
        "l_sigma": a(ssm.l_sigma),
        "z_scale": None if ssm.z_scale is None else a(ssm.z_scale),
    }
