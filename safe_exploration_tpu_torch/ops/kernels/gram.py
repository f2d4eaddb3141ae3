"""Masked, identity-padded RBF Gram matrix — wrapper of ``csrc/gram.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/gram.py::rbf_gram_masked``,
batched over the GP's output dims in one launch, from the raw
hyperparameters (the kernel forms exp(log_ls), exp(2 log_sf) and
exp(2 log_noise) + 1e-6 itself, so no other operation runs for a call):

    K_e[i, j] = m_i m_j sf_e^2 exp(-0.5 ||(x_i - x_j) / ls_e||^2)
                + delta_ij (m_i (exp(2 log_noise_e) + 1e-6) + 1 - m_i)

:func:`gram_plain` is the same function in plain PyTorch with the same
arguments, following ``models/gp._masked_gram``'s arithmetic; the wrapper
takes it for tensors on the CPU and launches the kernel for tensors on a
CUDA device.
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

__all__ = ["gram_plain", "rbf_gram_masked", "JITTER"]

JITTER = 1e-6
_ARGTYPES = (VP, VP, VP, VP, VP, VP, INT, INT, INT, INT, VP)


def gram_plain(x: torch.Tensor, mask: torch.Tensor, log_ls: torch.Tensor,
               log_sf: torch.Tensor, log_noise: torch.Tensor) -> torch.Tensor:
    """x (n, d), mask (n,), log_ls (e, d), log_sf (e,), log_noise (e,) ->
    K (e, n, n), in the arithmetic of ``_masked_gram`` per output dim."""
    ls, sf2 = torch.exp(log_ls), torch.exp(2.0 * log_sf)
    noise = torch.exp(2.0 * log_noise) + JITTER
    xs = x[None] / ls[:, None, :]                            # (e, n, d)
    nrm = torch.sum(xs * xs, dim=-1)                         # (e, n)
    d2 = nrm[:, :, None] + nrm[:, None, :] - 2.0 * (xs @ xs.transpose(1, 2))
    k = sf2[:, None, None] * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
    k = k * (mask[:, None] * mask[None, :])
    diag = mask[None, :] * noise[:, None] + (1.0 - mask)[None, :]
    return k + torch.diag_embed(diag)


def rbf_gram_masked(x: torch.Tensor, mask: torch.Tensor, log_ls: torch.Tensor,
                    log_sf: torch.Tensor, log_noise: torch.Tensor
                    ) -> torch.Tensor:
    """K (e, n, n) as :func:`gram_plain`; one kernel launch on CUDA and no
    other operation (the inputs must be contiguous)."""
    if not on_cuda(x, mask, log_ls, log_sf, log_noise):
        return gram_plain(x, mask, log_ls, log_sf, log_noise)
    n, d = x.shape
    e = log_ls.shape[0]
    if mask.shape != (n,) or log_ls.shape != (e, d) or log_sf.shape != (e,) \
            or log_noise.shape != (e,):
        raise ValueError(
            f"rbf_gram_masked: shapes x {tuple(x.shape)}, mask "
            f"{tuple(mask.shape)}, log_ls {tuple(log_ls.shape)}, log_sf "
            f"{tuple(log_sf.shape)}, log_noise {tuple(log_noise.shape)}"
        )
    check("rbf_gram_masked", x, mask, log_ls, log_sf, log_noise)
    out = torch.empty((e, n, n), dtype=x.dtype, device=x.device)
    fn = _build.load("gram", "gram_rbf_masked", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), mask.data_ptr(), log_ls.data_ptr(),
                  log_sf.data_ptr(), log_noise.data_ptr(), out.data_ptr(), e,
                  n, d, is_f64(x), stream_ptr(x))
    raise_on_error("rbf_gram_masked", code)
    rbf_gram_masked.launches += 1
    return out


rbf_gram_masked.launches = 0
