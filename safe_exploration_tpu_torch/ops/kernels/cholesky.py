"""Blocked lower Cholesky — wrapper of ``csrc/cholesky.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/cholesky.py::cholesky_blocked``.
Batched over leading dims: one launch with each matrix in one SM's shared
memory up to n = 224 in f32 (160 in f64), two launches per 64 columns for
all matrices above. A non-positive pivot gives NaN from that column on
and does not raise — the semantics of the Pallas kernel and of
``jnp.linalg.cholesky``, which ``torch.linalg.cholesky`` (raises) does not
share; :func:`cholesky_plain` is therefore a textbook column loop, not a
library call.
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

__all__ = ["cholesky_blocked", "cholesky_plain", "MAX_N"]

MAX_N = 1024
_ARGTYPES = (VP, VP, INT, INT, INT, VP)


def cholesky_plain(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n), column by column (reads the
    lower triangle only); a non-positive pivot gives NaN."""
    n = a.shape[-1]
    l = torch.zeros_like(a)
    nan = torch.tensor(float("nan"), dtype=a.dtype, device=a.device)
    for j in range(n):
        lj = l[..., j, :j]
        s = a[..., j, j] - torch.sum(lj * lj, dim=-1)
        d = torch.where(s > 0, torch.sqrt(torch.clamp(s, min=0.0)), nan)
        l[..., j, j] = d
        if j + 1 < n:
            below = a[..., j + 1:, j] - (
                l[..., j + 1:, :j] @ lj.unsqueeze(-1)
            ).squeeze(-1)
            l[..., j + 1:, j] = below / d.unsqueeze(-1)
    return l


def cholesky_blocked(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n) with n <= 1024: the CUDA kernel
    on a CUDA tensor, :func:`cholesky_plain` on a CPU tensor."""
    if not on_cuda(a):
        return cholesky_plain(a)
    n = a.shape[-1]
    if a.ndim < 2 or a.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"cholesky_blocked: needs (..., n, n) with "
                         f"n <= {MAX_N}; got {tuple(a.shape)}")
    check("cholesky_blocked", a)
    e = a.numel() // (n * n)
    out = torch.empty_like(a)
    fn = _build.load("cholesky", "cholesky_blocked", _ARGTYPES)
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), out.data_ptr(), e, n, is_f64(a),
                  stream_ptr(a))
    raise_on_error("cholesky_blocked", code)
    cholesky_blocked.launches += 1
    return out


cholesky_blocked.launches = 0
