"""Ellipsoid calculus — port of ``safe_exploration_tpu/ops/ellipsoid.py``.

An ellipsoid is a center ``p`` in R^n and a PSD shape matrix ``Q``:

    E(p, Q) = { x : (x - p)^T Q^{-1} (x - p) <= 1 }.

Every function takes leading batch dimensions (``p`` (..., n), ``Q``
(..., n, n)), which is how the portable CEM scores its samples at once.
"""

from __future__ import annotations

import torch

__all__ = [
    "sum_two_ellipsoids",
    "ellipsoid_from_rectangle",
    "sample_inside_ellipsoid",
    "distance_to_center",
]


def _trace(q: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(q, dim1=-2, dim2=-1).sum(-1)


def sum_two_ellipsoids(p1: torch.Tensor, q1: torch.Tensor, p2: torch.Tensor,
                       q2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Trace-minimal outer ellipsoid of the Minkowski sum
    ``E(p1, Q1) + E(p2, Q2)``: ``E(p1 + p2, (1 + 1/c) Q1 + (1 + c) Q2)`` with
    ``c = sqrt(tr Q1 / tr Q2)`` (a 1e-30 floor on both traces keeps a
    degenerate side finite)."""
    eps = 1e-30
    c = torch.sqrt((_trace(q1) + eps) / (_trace(q2) + eps))[..., None, None]
    return p1 + p2, (1.0 + 1.0 / c) * q1 + (1.0 + c) * q2


def ellipsoid_from_rectangle(ub: torch.Tensor) -> torch.Tensor:
    """Axis-aligned ellipsoid through the corners of the box [-ub, ub]^n:
    ``Q = diag(n * ub_i^2)``."""
    return torch.diag_embed(ub.shape[-1] * ub * ub)


def sample_inside_ellipsoid(generator: torch.Generator | None, num: int,
                            p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``num`` points uniform inside E(p, Q) (p (n,), Q (n, n)): a Gaussian
    direction times radius U^(1/n), pushed through the Cholesky factor of Q.
    The draws come from ``generator`` on its device."""
    n = p.shape[-1]
    dev = p.device if generator is None else generator.device
    g = torch.randn((num, n), generator=generator, dtype=p.dtype, device=dev)
    r = torch.rand((num, 1), generator=generator, dtype=p.dtype, device=dev)
    ball = (g / torch.linalg.norm(g, dim=-1, keepdim=True)) * r ** (1.0 / n)
    chol = torch.linalg.cholesky(
        q + 1e-12 * torch.eye(n, dtype=q.dtype, device=q.device))
    return ball.to(p.device) @ chol.T + p


def distance_to_center(samples: torch.Tensor, p: torch.Tensor,
                       q: torch.Tensor) -> torch.Tensor:
    """Squared Mahalanobis distance ``(x - p)^T Q^{-1} (x - p)`` of each of
    the (m, n) samples; a point is inside E(p, Q) iff it is <= 1."""
    d = samples - p
    sol = torch.linalg.solve(q, d.T)
    return torch.sum(d.T * sol, dim=0)

