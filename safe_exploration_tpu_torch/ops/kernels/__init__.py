"""Hand-written CUDA kernels of the GP refit, each beside its plain version.

  gram.py      masked identity-padded RBF Gram   (csrc/gram.cu)
  cholesky.py  blocked lower Cholesky            (csrc/cholesky.cu)
  trsm.py      blocked triangular solves, PSD solve (csrc/trsm.cu)

Every wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device (raising if the kernel
cannot be built or launched — there is no fallback). Each wrapper counts
its launches in a ``launches`` attribute.
"""

from safe_exploration_tpu_torch.ops.kernels.cholesky import (
    cholesky_blocked,
    cholesky_plain,
)
from safe_exploration_tpu_torch.ops.kernels.gram import gram_plain, rbf_gram_masked
from safe_exploration_tpu_torch.ops.kernels.trsm import (
    solve_psd,
    trsm_lower,
    trsm_plain,
)

KERNEL_WRAPPERS = (rbf_gram_masked, cholesky_blocked, trsm_lower)

__all__ = [
    "KERNEL_WRAPPERS", "cholesky_blocked", "cholesky_plain", "gram_plain",
    "rbf_gram_masked", "solve_psd", "trsm_lower", "trsm_plain",
]
