"""Hand-written CUDA kernels, each beside its plain version.

  gram.py        masked identity-padded RBF Gram   (csrc/gram.cu)
  cholesky.py    blocked lower Cholesky            (csrc/cholesky.cu)
  cholesky_hbm.py  right-looking Cholesky, n > 1024 (csrc/cholesky_hbm.cu)
  trsm.py        triangular solves, PSD solve, triangular inverse
                 (csrc/trsm.cu)
  gp_predict.py  fused lane GP posterior (+ mean Jacobian) on a posterior
                 prepared once per model          (csrc/gp_predict.cu)
  cem_score.py   whole-tube constrained-CEM score  (csrc/cem_score.cu)

The first four run the GP refit (cholesky up to n = 1024, cholesky_hbm
above), the last two the lane CEM planner; gp_predict and cem_score share
one block posterior (csrc/gp_lanes.cuh) and one prepared model
(``prepare_posterior``). Every wrapper takes the plain PyTorch version for
a tensor on the CPU and launches its kernel for a tensor on a CUDA device
(raising if the kernel cannot be built or launched — there is no
fallback). Each wrapper counts its launches in a ``launches`` attribute.
"""

from safe_exploration_tpu_torch.ops.kernels.cem_score import (
    cem_score_supported,
    prepare_tube_score,
    tube_score_lanes,
    tube_score_plain,
    tube_score_prepared,
)
from safe_exploration_tpu_torch.ops.kernels.cholesky import (
    cholesky_blocked,
    cholesky_plain,
)
from safe_exploration_tpu_torch.ops.kernels.cholesky_hbm import (
    cholesky_hbm,
    cholesky_hbm_plain,
)
from safe_exploration_tpu_torch.ops.kernels.gp_predict import (
    LanePosterior,
    gp_of,
    gp_pallas_supported,
    gp_predict_lanes,
    gp_predict_plain,
    gp_predict_prepared,
    posterior_plain,
    prepare_posterior,
)
from safe_exploration_tpu_torch.ops.kernels.gram import gram_plain, rbf_gram_masked
from safe_exploration_tpu_torch.ops.kernels.trsm import (
    solve_psd,
    solve_psd_plain,
    tri_inv_lower,
    tri_inv_plain,
    trsm_lower,
    trsm_plain,
)

KERNEL_WRAPPERS = (rbf_gram_masked, cholesky_blocked, trsm_lower, solve_psd,
                   tri_inv_lower, gp_predict_prepared, tube_score_prepared,
                   cholesky_hbm)

__all__ = [
    "KERNEL_WRAPPERS", "LanePosterior", "cem_score_supported",
    "cholesky_blocked", "cholesky_hbm", "cholesky_hbm_plain",
    "cholesky_plain", "gp_of", "gp_pallas_supported", "gp_predict_lanes",
    "gp_predict_plain", "gp_predict_prepared", "gram_plain",
    "posterior_plain", "prepare_posterior", "prepare_tube_score",
    "rbf_gram_masked", "solve_psd", "solve_psd_plain", "tri_inv_lower",
    "tri_inv_plain", "trsm_lower", "trsm_plain", "tube_score_lanes",
    "tube_score_plain", "tube_score_prepared",
]
