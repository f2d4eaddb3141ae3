"""Numerical linear algebra for the control stack.

Port of ``safe_exploration_tpu/ops/linalg.py``: the structure-preserving
doubling DARE solver, discrete LQR and exact zero-order-hold discretization.
All matrices here are tiny (n <= ~12), so plain PyTorch is the right tool.
"""

from __future__ import annotations

import torch

__all__ = ["dare_sda", "dlqr", "expm_discretize"]


def dare_sda(
    a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, r: torch.Tensor, *,
    iters: int = 25,
) -> torch.Tensor:
    """Stabilizing solution X of the discrete algebraic Riccati equation

        X = A^T X A - A^T X B (R + B^T X B)^{-1} B^T X A + Q

    via the structure-preserving doubling algorithm with A_0 = A,
    G_0 = B R^{-1} B^T, H_0 = Q (H_k -> X); 25 fixed doublings, as in the
    JAX reference.
    """
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    ak, gk, hk = a, b @ torch.linalg.solve(r, b.T), q
    for _ in range(iters):
        w = torch.linalg.solve(eye + gk @ hk, ak)
        wg = torch.linalg.solve(eye + gk @ hk, gk)
        a_next = ak @ w
        g_next = gk + ak @ wg @ ak.T
        h_next = hk + ak.T @ hk @ w
        ak = a_next
        gk = 0.5 * (g_next + g_next.T)
        hk = 0.5 * (h_next + h_next.T)
    return hk


def dlqr(
    a: torch.Tensor, b: torch.Tensor, q: torch.Tensor, r: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Discrete-time LQR gain (K, P) with ``u = -K x`` optimal for
    sum x'Qx + u'Ru; the safe-MPC uses ``k_fb = -K``."""
    p = dare_sda(a, b, q, r)
    k = torch.linalg.solve(r + b.T @ p @ b, b.T @ p @ a)
    return k, p


def expm_discretize(
    a_cont: torch.Tensor, b_cont: torch.Tensor, dt
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact zero-order-hold discretization of ``xdot = A x + B u`` through
    ``expm(dt * [[A, B], [0, 0]]) = [[Ad, Bd], [0, I]]``."""
    n_s = a_cont.shape[-1]
    n_u = b_cont.shape[-1]
    m = torch.zeros((n_s + n_u, n_s + n_u), dtype=a_cont.dtype,
                    device=a_cont.device)
    m[:n_s, :n_s] = a_cont
    m[:n_s, n_s:] = b_cont
    em = torch.linalg.matrix_exp(m * dt)
    return em[:n_s, :n_s], em[:n_s, n_s:]
