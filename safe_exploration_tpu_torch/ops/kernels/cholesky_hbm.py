"""Left-looking block-column Cholesky for large matrices — wrapper of
``csrc/cholesky_hbm.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/cholesky_hbm.py::cholesky_hbm``,
the tier for matrices beyond :data:`cholesky.MAX_N`. Batched over leading
dims (one chain of launches for all matrices). Same contract as
:func:`cholesky_blocked`: only the lower triangle is read, any n >= 1, and a
non-positive pivot gives NaN from that column on (``torch.linalg.cholesky``
raises instead, so the plain version is written out).
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
from safe_exploration_tpu_torch.ops.kernels.cholesky import cholesky_plain
from safe_exploration_tpu_torch.ops.kernels.trsm import trsm_plain

__all__ = ["cholesky_hbm", "cholesky_hbm_plain", "PANEL"]

PANEL = 64        # block-column width P (the kernel reports it too)
MAX_SPLITS = 16   # most depth splits of one column update (workspace size)
_ARGTYPES = (VP, VP, VP, INT, INT, INT, INT, VP)


def cholesky_hbm_plain(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n), left-looking over block columns
    of width :data:`PANEL` as the kernel: update the column with the finished
    ones, factor its diagonal block (:func:`cholesky_plain`), and solve the
    strip below, S L_kk^-T, by substitution (:func:`trsm_plain`). Reads the
    lower triangle only; a non-positive pivot gives NaN from that column
    on."""
    n = a.shape[-1]
    l = torch.zeros_like(a)
    for k0 in range(0, n, PANEL):
        k1 = min(k0 + PANEL, n)
        done = l[..., k0:, :k0]
        s = a[..., k0:, k0:k1] - done @ done[..., :k1 - k0, :].transpose(-1, -2)
        lkk = cholesky_plain(s[..., :k1 - k0, :])
        l[..., k0:k1, k0:k1] = lkk
        if k1 < n:
            strip = s[..., k1 - k0:, :].transpose(-1, -2).contiguous()
            l[..., k1:, k0:k1] = trsm_plain(lkk, strip).transpose(-1, -2)
    return l


def cholesky_hbm(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n), any n: the CUDA kernel on a CUDA
    tensor, :func:`cholesky_hbm_plain` on a CPU tensor."""
    if not on_cuda(a):
        return cholesky_hbm_plain(a)
    n = a.shape[-1]
    if a.ndim < 2 or a.shape[-2] != n or n < 1:
        raise ValueError(f"cholesky_hbm: needs (..., n, n); got {tuple(a.shape)}")
    check("cholesky_hbm", a)
    e = a.numel() // (n * n)
    out = torch.empty_like(a)
    work = torch.empty((MAX_SPLITS * e * n * PANEL,), dtype=a.dtype,
                       device=a.device)
    if _build.load("cholesky_hbm", "cholesky_hbm_panel", ())() != PANEL:
        raise RuntimeError("cholesky_hbm: csrc/cholesky_hbm.cu has another "
                           "block-column width than PANEL")
    fn = _build.load("cholesky_hbm", "cholesky_hbm", _ARGTYPES)
    with torch.cuda.device(a.device):
        code = fn(a.data_ptr(), out.data_ptr(), work.data_ptr(), e, n,
                  MAX_SPLITS, is_f64(a), stream_ptr(a))
    raise_on_error("cholesky_hbm", code)
    cholesky_hbm.launches += 1
    return out


cholesky_hbm.launches = 0
