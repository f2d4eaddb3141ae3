"""Hand-written CUDA kernels, each beside its plain version.

  gram.py        masked identity-padded RBF Gram   (csrc/gram.cu)
  cholesky.py    blocked lower Cholesky            (csrc/cholesky.cu)
  trsm.py        blocked triangular solves, PSD solve (csrc/trsm.cu)
  gp_predict.py  fused lane GP posterior (+ mean Jacobian) (csrc/gp_predict.cu)
  cem_score.py   whole-tube constrained-CEM score  (csrc/cem_score.cu)

The first three run the GP refit, the last two the lane CEM planner. Every
wrapper takes the plain PyTorch version for a tensor on the CPU and
launches its kernel for a tensor on a CUDA device (raising if the kernel
cannot be built or launched — there is no fallback). Each wrapper counts
its launches in a ``launches`` attribute.
"""

from safe_exploration_tpu_torch.ops.kernels.cem_score import (
    cem_score_supported,
    tube_score_lanes,
    tube_score_plain,
)
from safe_exploration_tpu_torch.ops.kernels.cholesky import (
    cholesky_blocked,
    cholesky_plain,
)
from safe_exploration_tpu_torch.ops.kernels.gp_predict import (
    gp_pallas_supported,
    gp_predict_lanes,
    gp_predict_plain,
)
from safe_exploration_tpu_torch.ops.kernels.gram import gram_plain, rbf_gram_masked
from safe_exploration_tpu_torch.ops.kernels.trsm import (
    solve_psd,
    trsm_lower,
    trsm_plain,
)

KERNEL_WRAPPERS = (rbf_gram_masked, cholesky_blocked, trsm_lower,
                   gp_predict_lanes, tube_score_lanes)

__all__ = [
    "KERNEL_WRAPPERS", "cem_score_supported", "cholesky_blocked",
    "cholesky_plain", "gp_pallas_supported", "gp_predict_lanes",
    "gp_predict_plain", "gram_plain", "rbf_gram_masked", "solve_psd",
    "trsm_lower", "trsm_plain", "tube_score_lanes", "tube_score_plain",
]
