"""Masked, identity-padded RBF Gram matrix — wrapper of ``csrc/gram.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/gram.py::rbf_gram_masked``,
batched over a leading axis of L models (the lanes of a stacked GP) and
over the GP's output dims in one launch, from the raw hyperparameters (the
kernel forms exp(log_ls), exp(2 log_sf) and exp(2 log_noise) + 1e-6
itself, so no other operation runs for a call):

    K_le[i, j] = m_li m_lj sf_le^2 exp(-0.5 ||(x_li - x_lj) / ls_le||^2)
                 + delta_ij (m_li (exp(2 log_noise_le) + 1e-6) + 1 - m_li)

``x`` is (n, d) for one model or (L, n, d); the mask is (n,) shared or
(L, n), the hyperparameters (e, .) or (L, e, .), one set per model.
:func:`gram_plain` is the same function in plain PyTorch with the same
arguments, in the Pallas kernel's norm form; the wrapper
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
_ARGTYPES = (VP, VP, VP, VP, VP, VP, INT, INT, INT, INT, INT, INT, VP)


def gram_plain(x: torch.Tensor, mask: torch.Tensor, log_ls: torch.Tensor,
               log_sf: torch.Tensor, log_noise: torch.Tensor) -> torch.Tensor:
    """x (n, d) or (L, n, d), mask (n,) or (L, n), log_ls (e, d) or
    (L, e, d), log_sf and log_noise (e,) or (L, e) (the hyperparameters
    with x's leading axis) -> K (e, n, n) or (L, e, n, n), in the
    Pallas kernel's arithmetic per output dim."""
    ls, sf2 = torch.exp(log_ls), torch.exp(2.0 * log_sf)
    noise = torch.exp(2.0 * log_noise) + JITTER
    xs = x[..., None, :, :] / ls[..., :, None, :]            # (.., e, n, d)
    nrm = torch.sum(xs * xs, dim=-1)                         # (.., e, n)
    d2 = nrm[..., :, None] + nrm[..., None, :] - 2.0 * (xs @ xs.mT)
    k = sf2[..., :, None, None] * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
    k = k * (mask[..., None, :, None] * mask[..., None, None, :])
    diag = mask[..., None, :] * noise[..., :, None] + (1.0 - mask)[..., None, :]
    return k + torch.diag_embed(diag)


def _launch_shape(x, mask, log_ls, log_sf, log_noise):
    """(L, e, n, d, mask_per_lane) of a launch; raises on shapes the kernel
    does not take."""
    lead, (n, d) = x.shape[:-2], x.shape[-2:]
    e = log_ls.shape[-2] if log_ls.ndim >= 2 else 0
    if (x.ndim not in (2, 3) or e < 1 or log_ls.shape != lead + (e, d)
            or log_sf.shape != lead + (e,) or log_noise.shape != lead + (e,)
            or mask.shape not in (lead + (n,), (n,))):
        raise ValueError(
            f"rbf_gram_masked: shapes x {tuple(x.shape)}, mask "
            f"{tuple(mask.shape)}, log_ls {tuple(log_ls.shape)}, log_sf "
            f"{tuple(log_sf.shape)}, log_noise {tuple(log_noise.shape)}"
        )
    return x.shape[0] if lead else 1, e, n, d, int(mask.ndim == 2)


def rbf_gram_masked(x: torch.Tensor, mask: torch.Tensor, log_ls: torch.Tensor,
                    log_sf: torch.Tensor, log_noise: torch.Tensor
                    ) -> torch.Tensor:
    """K as :func:`gram_plain`: (e, n, n) for x (n, d), (L, e, n, n) for x
    (L, n, d); one kernel launch on CUDA for all L * e Grams and no other
    operation (the inputs must be contiguous)."""
    if not on_cuda(x, mask, log_ls, log_sf, log_noise):
        return gram_plain(x, mask, log_ls, log_sf, log_noise)
    lanes, e, n, d, mask_lane = _launch_shape(x, mask, log_ls, log_sf,
                                              log_noise)
    check("rbf_gram_masked", x, mask, log_ls, log_sf, log_noise)
    out = torch.empty(x.shape[:-2] + (e, n, n), dtype=x.dtype,
                      device=x.device)
    fn = _build.load("gram", "gram_rbf_masked", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), mask.data_ptr(), log_ls.data_ptr(),
                  log_sf.data_ptr(), log_noise.data_ptr(), out.data_ptr(),
                  lanes, e, n, d, mask_lane, is_f64(x), stream_ptr(x))
    raise_on_error("rbf_gram_masked", code)
    rbf_gram_masked.launches += 1
    return out


rbf_gram_masked.launches = 0
