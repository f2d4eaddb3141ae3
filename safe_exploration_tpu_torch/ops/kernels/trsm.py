"""Blocked triangular solves — wrapper of ``csrc/trsm.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/trsm.py::trsm_lower_blocked`` and
``solve_psd_blocked``: ``L X = B`` (or ``L^T X = B`` with ``transpose``) for
lower L (..., n, n) and B (..., n, m), batched over leading dims in one
launch. :func:`trsm_plain` is row-by-row substitution in plain PyTorch.
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

__all__ = ["solve_psd", "trsm_lower", "trsm_plain"]

_ARGTYPES = (VP, VP, VP, INT, INT, INT, INT, INT, VP)


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


def trsm_lower(l: torch.Tensor, b: torch.Tensor, transpose: bool = False
               ) -> torch.Tensor:
    """X = L^-1 B (or L^-T B): the CUDA kernel on CUDA tensors,
    :func:`trsm_plain` on CPU tensors."""
    if not on_cuda(l, b):
        return trsm_plain(l, b, transpose)
    n = l.shape[-1]
    if l.ndim < 2 or l.shape[-2] != n or b.ndim != l.ndim \
            or b.shape[:-1] != l.shape[:-1]:
        raise ValueError(f"trsm_lower: L {tuple(l.shape)} and B "
                         f"{tuple(b.shape)} do not match as (..., n, n), "
                         "(..., n, m)")
    check("trsm_lower", l, b)
    m = b.shape[-1]
    e = l.numel() // (n * n)
    out = torch.empty_like(b)
    fn = _build.load("trsm", "trsm_lower", _ARGTYPES)
    with torch.cuda.device(l.device):
        code = fn(l.data_ptr(), b.data_ptr(), out.data_ptr(), e, n, m,
                  int(transpose), is_f64(l), stream_ptr(l))
    raise_on_error("trsm_lower", code)
    trsm_lower.launches += 1
    return out


trsm_lower.launches = 0


def solve_psd(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given the lower Cholesky factor: two solves."""
    return trsm_lower(l, trsm_lower(l, b), transpose=True)
