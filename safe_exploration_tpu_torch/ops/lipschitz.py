"""Lipschitz over-approximation of GP linearization remainders — port of
``safe_exploration_tpu/ops/lipschitz.py``.

Over the state ellipsoid E(0, Q) under feedback u = k_fb x the lifted set is
``S E(0, Q)`` with ``S = [I; k_fb]``; its squared radius is
``r^2 = lambda_max(Q S^T S)``, and per output dim the remainder boxes have
half-widths ``0.5 l_mu r^2`` (Taylor) and ``l_sigma r`` (std growth).
Leading batch dimensions are allowed throughout.
"""

from __future__ import annotations

import torch

__all__ = ["max_eig_psd_product", "compute_remainder_overapproximations"]


def max_eig_psd_product(m: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Dominant eigenvalue of ``M = Q B`` (Q, B PSD; M (..., n, n)).

    n <= 2 in closed form; above, the JAX package's repeated squaring (three
    trace-normalized squarings) and ``max(2, ceil(iters / 8))`` power steps,
    finished by the Rayleigh quotient on the original M.
    """
    n = m.shape[-1]
    if n == 1:
        return torch.clamp(m[..., 0, 0], min=0.0)
    if n == 2:
        tr = m[..., 0, 0] + m[..., 1, 1]
        det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
        return torch.clamp(0.5 * (tr + disc), min=0.0)

    def trace(a):
        return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)[..., None, None]

    v = 1.0 + 1e-3 * torch.arange(n, dtype=m.dtype, device=m.device)
    v = (v / torch.linalg.norm(v)).expand(m.shape[:-1]).unsqueeze(-1)
    mn = m / (trace(m) / n + 1e-30)
    n_sq = 3
    n_refine = max(2, (iters + (1 << n_sq) - 1) // (1 << n_sq))
    for _ in range(n_sq):
        mn = mn @ mn
        mn = mn / (trace(mn) / n + 1e-30)
    for _ in range(n_refine):
        w = mn @ v
        v = w / (torch.linalg.norm(w, dim=-2, keepdim=True) + 1e-30)
    num = (v * (m @ v)).sum((-2, -1))
    return torch.clamp(num / ((v * v).sum((-2, -1)) + 1e-30), min=0.0)


def compute_remainder_overapproximations(
    q: torch.Tensor, k_fb: torch.Tensor, l_mu: torch.Tensor,
    l_sigma: torch.Tensor, *, iters: int = 30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Box half-widths (u_mu, u_sigma), each (..., n_out), bounding the GP
    linearization remainders over E(0, Q) (q (..., n_s, n_s), k_fb
    (n_u, n_s))."""
    n_s = q.shape[-1]
    s = torch.cat([torch.eye(n_s, dtype=q.dtype, device=q.device), k_fb], 0)
    r_sqr = max_eig_psd_product(q @ (s.T @ s), iters=iters)[..., None]
    return 0.5 * l_mu * r_sqr, l_sigma * torch.sqrt(r_sqr)
