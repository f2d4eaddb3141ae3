"""Masked, identity-padded RBF Gram matrix — wrapper of ``csrc/gram.cu``.

Replaces ``safe_exploration_tpu/ops/pallas/gram.py::rbf_gram_masked``,
batched over the GP's output dims in one launch:

    K_e[i, j] = m_i m_j sf_e^2 exp(-0.5 ||(x_i - x_j) / ls_e||^2)
                + delta_ij (m_i (noise_e + 1e-6) + 1 - m_i)

:func:`gram_plain` is the same function in plain PyTorch, following
``models/gp._masked_gram``'s arithmetic; the wrapper takes it for tensors on
the CPU and launches the kernel for tensors on a CUDA device.
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


def _hyper(log_ls, log_sf, noise_var):
    """Lengthscales (e, d), signal variances (e,), noise + jitter (e,)."""
    return (torch.exp(log_ls), torch.exp(2.0 * log_sf), noise_var + JITTER)


def gram_plain(x: torch.Tensor, mask: torch.Tensor, log_ls: torch.Tensor,
               log_sf: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    """x (n, d), mask (n,), log_ls (e, d), log_sf (e,), noise_var (e,) ->
    K (e, n, n), in the arithmetic of ``_masked_gram`` per output dim."""
    ls, sf2, noise = _hyper(log_ls, log_sf, noise_var)
    xs = x[None] / ls[:, None, :]                            # (e, n, d)
    nrm = torch.sum(xs * xs, dim=-1)                         # (e, n)
    d2 = nrm[:, :, None] + nrm[:, None, :] - 2.0 * (xs @ xs.transpose(1, 2))
    k = sf2[:, None, None] * torch.exp(-0.5 * torch.clamp(d2, min=0.0))
    k = k * (mask[:, None] * mask[None, :])
    diag = mask[None, :] * noise[:, None] + (1.0 - mask)[None, :]
    return k + torch.diag_embed(diag)


def rbf_gram_masked(x: torch.Tensor, mask: torch.Tensor, log_ls: torch.Tensor,
                    log_sf: torch.Tensor, noise_var: torch.Tensor
                    ) -> torch.Tensor:
    """K (e, n, n) as :func:`gram_plain`; one kernel launch on CUDA."""
    if not on_cuda(x, mask, log_ls, log_sf, noise_var):
        return gram_plain(x, mask, log_ls, log_sf, noise_var)
    n, d = x.shape
    e = log_ls.shape[0]
    if mask.shape != (n,) or log_ls.shape != (e, d) or log_sf.shape != (e,) \
            or noise_var.shape != (e,):
        raise ValueError(
            f"rbf_gram_masked: shapes x {tuple(x.shape)}, mask "
            f"{tuple(mask.shape)}, log_ls {tuple(log_ls.shape)}, log_sf "
            f"{tuple(log_sf.shape)}, noise_var {tuple(noise_var.shape)}"
        )
    ls, sf2, noise = (t.contiguous() for t in _hyper(log_ls, log_sf, noise_var))
    check("rbf_gram_masked", x, mask, ls, sf2, noise)
    out = torch.empty((e, n, n), dtype=x.dtype, device=x.device)
    fn = _build.load("gram", "gram_rbf_masked", _ARGTYPES)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), mask.data_ptr(), ls.data_ptr(),
                  sf2.data_ptr(), noise.data_ptr(), out.data_ptr(), e, n, d,
                  is_f64(x), stream_ptr(x))
    raise_on_error("rbf_gram_masked", code)
    rbf_gram_masked.launches += 1
    return out


rbf_gram_masked.launches = 0
