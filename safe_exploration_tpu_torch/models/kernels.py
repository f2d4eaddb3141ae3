"""GP covariance kernels — port of ``safe_exploration_tpu/models/kernels.py``.

This slice carries the squared-exponential (ARD RBF) kernel, the default of
every pendulum configuration. Hyperparameters live in log space, one dict of
tensors per output dimension.
"""

from __future__ import annotations

import torch

__all__ = ["KERNELS", "init_kernel_params", "gram", "kernel_diag"]


def _sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances (n1, d) x (n2, d) -> (n1, n2) in the
    ||a||^2 + ||b||^2 - 2ab matmul form, floored at 0 with ``maximum``,
    whose derivative at the tie is 1/2 as JAX's (``clamp``'s is 1): the
    Lipschitz estimate differentiates twice through it."""
    n1 = torch.sum(x1 * x1, dim=-1, keepdim=True)
    n2 = torch.sum(x2 * x2, dim=-1, keepdim=True)
    d2 = n1 + n2.T - 2.0 * (x1 @ x2.T)
    return torch.maximum(d2, torch.zeros_like(d2))


def _k_rbf(params: dict, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared-exponential (ARD): sigma_f^2 exp(-0.5 sum_d (dx_d / l_d)^2)."""
    ls = torch.exp(params["log_lengthscales"])
    var = torch.exp(2.0 * params["log_sf"])
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
    """diag k(x, x) for a batch of points, shape (n,)."""
    _check(kern_type)
    var = torch.exp(2.0 * params["log_sf"])
    return var * torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
