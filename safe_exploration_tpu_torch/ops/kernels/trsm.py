"""Triangular solves and the triangular inverse — wrapper of ``csrc/trsm.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/trsm.py::trsm_lower_blocked`` and
``solve_psd_blocked``, batched over leading dims in one call, with three
entries fitted to the GP refit's three call shapes:

- :func:`trsm_lower` — ``L X = B`` (or ``L^T X = B`` with ``transpose``) for
  lower L (..., n, n) and any B (..., n, m);
- :func:`solve_psd` — ``(L L^T) X = B``, one launch after the diagonal
  inverses for the refit's m = 1 (beta);
- :func:`tri_inv_lower` — ``L^-1`` itself (the refit's K^-1 = L^-T L^-1),
  the value ``trsm_lower(l, I)`` has, without reading a right-hand side.

The plain versions substitute row by row (:func:`trsm_plain`) and compose
it (:func:`solve_psd_plain`, :func:`tri_inv_plain`).
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

__all__ = ["solve_psd", "solve_psd_plain", "tri_inv_lower",
           "tri_inv_plain", "trsm_lower", "trsm_plain"]

# the diagonal-block edge, NB in csrc/trsm.cu: the inverses' workspace holds
# one BLOCK x BLOCK block per row block of each matrix
BLOCK = 64


def trsm_plain(l: torch.Tensor, b: torch.Tensor, transpose: bool = False
               ) -> torch.Tensor:
    """X with L X = B (or L^T X = B), row by row; reads L's lower triangle."""
    n = l.shape[-1]
    x = torch.zeros_like(b)
    rows = range(n - 1, -1, -1) if transpose else range(n)
    for i in rows:
        if transpose:
            coef = l[..., i + 1:, i].unsqueeze(-2)           # (..., 1, n-i-1)
            done = x[..., i + 1:, :]
        else:
            coef = l[..., i, :i].unsqueeze(-2)               # (..., 1, i)
            done = x[..., :i, :]
        rhs = b[..., i, :] - (coef @ done).squeeze(-2)
        x[..., i, :] = rhs / l[..., i, i].unsqueeze(-1)
    return x


def solve_psd_plain(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X with (L L^T) X = B: a forward, then a transposed substitution."""
    return trsm_plain(l, trsm_plain(l, b), transpose=True)


def tri_inv_plain(l: torch.Tensor) -> torch.Tensor:
    """L^-1 by substitution against the identity."""
    n = l.shape[-1]
    eye = torch.eye(n, dtype=l.dtype, device=l.device).expand(l.shape)
    return trsm_plain(l, eye.contiguous())


def _shapes(name: str, l: torch.Tensor, b: torch.Tensor | None):
    """(e, n, m) of a launch; raises on shapes the kernels do not take."""
    n = l.shape[-1]
    if l.ndim < 2 or l.shape[-2] != n or (b is not None and (
            b.ndim != l.ndim or b.shape[:-1] != l.shape[:-1])):
        got = "" if b is None else f" and B {tuple(b.shape)}"
        raise ValueError(f"{name}: L {tuple(l.shape)}{got} do not match as "
                         "(..., n, n), (..., n, m)")
    check(name, l, *(() if b is None else (b,)))
    m = 1 if b is None else b.shape[-1]
    if n < 1 or m < 1:
        raise ValueError(f"{name}: empty matrix {tuple(l.shape)}")
    return l.numel() // (n * n), n, m


def _diag_workspace(l: torch.Tensor, e: int, n: int) -> torch.Tensor:
    """Room for the inverses of the 64 x 64 diagonal blocks."""
    nb = -(-n // BLOCK)
    return torch.empty((e * nb * BLOCK * BLOCK,), dtype=l.dtype,
                       device=l.device)


def trsm_lower(l: torch.Tensor, b: torch.Tensor, transpose: bool = False
               ) -> torch.Tensor:
    """X = L^-1 B (or L^-T B): the CUDA kernel on CUDA tensors,
    :func:`trsm_plain` on CPU tensors."""
    if not on_cuda(l, b):
        return trsm_plain(l, b, transpose)
    e, n, m = _shapes("trsm_lower", l, b)
    out = torch.empty_like(b)
    work = _diag_workspace(l, e, n)
    fn = _build.load("trsm", "trsm_lower",
                     (VP, VP, VP, VP, INT, INT, INT, INT, INT, VP))
    with torch.cuda.device(l.device):
        code = fn(l.data_ptr(), b.data_ptr(), out.data_ptr(),
                  work.data_ptr(), e, n, m, int(transpose), is_f64(l),
                  stream_ptr(l))
    raise_on_error("trsm_lower", code)
    trsm_lower.launches += 1
    return out


trsm_lower.launches = 0


def solve_psd(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given the lower Cholesky factor: the CUDA kernel
    (both solves in one launch for m = 1) on CUDA tensors,
    :func:`solve_psd_plain` on CPU tensors."""
    if not on_cuda(l, b):
        return solve_psd_plain(l, b)
    e, n, m = _shapes("solve_psd", l, b)
    out = torch.empty_like(b)
    work = _diag_workspace(l, e, n)
    fn = _build.load("trsm", "trsm_solve_psd",
                     (VP, VP, VP, VP, INT, INT, INT, INT, VP))
    with torch.cuda.device(l.device):
        code = fn(l.data_ptr(), b.data_ptr(), out.data_ptr(),
                  work.data_ptr(), e, n, m, is_f64(l), stream_ptr(l))
    raise_on_error("solve_psd", code)
    solve_psd.launches += 1
    return out


solve_psd.launches = 0


def tri_inv_lower(l: torch.Tensor) -> torch.Tensor:
    """L^-1 of lower L (..., n, n), zero above the diagonal: the CUDA kernel
    on a CUDA tensor, :func:`tri_inv_plain` on a CPU tensor."""
    if not on_cuda(l):
        return tri_inv_plain(l)
    e, n, _ = _shapes("tri_inv_lower", l, None)
    out = torch.empty_like(l)
    work = torch.empty_like(l)
    fn = _build.load("trsm", "tri_inv_lower", (VP, VP, VP, INT, INT, INT, VP))
    with torch.cuda.device(l.device):
        code = fn(l.data_ptr(), out.data_ptr(), work.data_ptr(), e, n,
                  is_f64(l), stream_ptr(l))
    raise_on_error("tri_inv_lower", code)
    tri_inv_lower.launches += 1
    return out


tri_inv_lower.launches = 0
