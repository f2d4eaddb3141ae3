"""GP covariance kernels — port of ``safe_exploration_tpu/models/kernels.py``.

This slice carries the squared-exponential (ARD RBF) kernel, the default of
every pendulum configuration. Hyperparameters live in log space, one dict of
tensors per output dimension.
"""

from __future__ import annotations

import torch

__all__ = ["KERNELS", "init_kernel_params", "gram", "kernel_diag",
           "weighted_mean_jac"]


def _sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (..., n1, d) x (..., n2, d) -> (..., n1,
    n2) as the sum over d of squared differences (the form of the JAX
    package's lane models, ``_lane_d2``), floored at 0 with ``maximum``,
    whose derivative at the tie is 1/2 as JAX's (``clamp``'s is 1): the
    Lipschitz estimate differentiates twice through it.

    Identical rows give exactly 0 whatever the summation order, as jitted
    XLA gives for the JAX package's ||a||^2 + ||b||^2 - 2ab form; a matmul
    cross term rounds otherwise, and the floor's derivative at a training
    input would follow that rounding. Both forms have the same first and
    second derivatives."""
    diff = x1[..., :, None, :] - x2[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return torch.maximum(d2, torch.zeros_like(d2))


def _k_rbf(params: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared-exponential (ARD): sigma_f^2 exp(-0.5 sum_d (dx_d / l_d)^2).
    Hyperparameters may carry leading lane axes matching the inputs'."""
    ls = torch.exp(params["log_lengthscales"])[..., None, :]
    var = torch.exp(2.0 * params["log_sf"])[..., None, None]
    return var * torch.exp(-0.5 * _sq_dists(x1 / ls, x2 / ls))


KERNELS = {"rbf": _k_rbf}


def _check(kern_type: str) -> None:
    if kern_type not in KERNELS:
        raise NotImplementedError(
            f"kernel {kern_type!r} is not ported yet (ROADMAP Queue 1, item 3: "
            "lin/mat52/composites); the port carries 'rbf'"
        )


def init_kernel_params(kern_type: str, input_dim: int, dtype=torch.float32,
                       device=None) -> dict:
    """Unit-scale initial hyperparameters (log-space) for a kernel type."""
    _check(kern_type)
    return {
        "log_lengthscales": torch.zeros((input_dim,), dtype=dtype,
                                        device=device),
        "log_sf": torch.zeros((), dtype=dtype, device=device),
    }


def gram(kern_type: str, params: dict, x1: torch.Tensor,
         x2: torch.Tensor) -> torch.Tensor:
    """Cross-covariance matrix k(x1, x2), shape (n1, n2)."""
    _check(kern_type)
    return KERNELS[kern_type](params, x1, x2)


def kernel_diag(kern_type: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    """diag k(x, x) for a batch of points (..., n, d) -> (..., n);
    hyperparameters may carry the leading lane axes."""
    _check(kern_type)
    var = torch.exp(2.0 * params["log_sf"])[..., None]
    return var * torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)


def weighted_mean_jac(kern_type: str, params: dict, z: torch.Tensor,
                      x: torch.Tensor, kv: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """Closed-form input gradient of weighted kernel sums at the queries z
    (m, d): d/dz sum_i c_i k(z, x_i) over the support rows x (n, d), given
    the cross-covariance ``kv`` (m, n) = k(z, x) -> (m, d) (leading lane
    axes pass through, ``c`` broadcasting against ``kv``). RBF:
    (sum_i c_i k_i x_i - z sum_i c_i k_i) / ls^2."""
    _check(kern_type)
    w = kv * c
    ls2 = torch.exp(2.0 * params["log_lengthscales"])[..., None, :]
    return (w @ x - torch.sum(w, dim=-1, keepdim=True) * z) / ls2
