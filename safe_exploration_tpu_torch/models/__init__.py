"""L2 dynamics models: the RBF kernel, the padded GP, the sparse
(inducing-point) GP and their state-space models."""

from safe_exploration_tpu_torch.models.gp import (
    GP,
    gp_init,
    gp_predict,
    gp_predict_mean_jac,
    gp_refit,
    gp_shrink_to_bucket,
    gp_update_data,
)
from safe_exploration_tpu_torch.models.kernels import (
    gram,
    init_kernel_params,
    kernel_diag,
)
from safe_exploration_tpu_torch.models.sparse_gp import (
    SparseGP,
    SparseGPSSM,
    make_sparse_gp_ssm,
    sparse_gp_fit,
    sparse_gp_init,
    sparse_gp_predict,
    sparse_gp_predict_mean_jac,
    sparse_gp_refit,
    sparse_gp_update_data,
)
from safe_exploration_tpu_torch.models.ssm import (
    GPSSM,
    make_gp_ssm,
    ssm_bucketed,
    ssm_noise_var,
    ssm_predict,
    ssm_predict_jac,
    ssm_update,
)

__all__ = [
    "GP", "gp_init", "gp_predict", "gp_predict_mean_jac", "gp_refit",
    "gp_shrink_to_bucket", "gp_update_data", "gram", "init_kernel_params",
    "kernel_diag", "GPSSM", "make_gp_ssm", "ssm_bucketed", "ssm_noise_var",
    "ssm_predict", "ssm_predict_jac", "ssm_update", "SparseGP",
    "SparseGPSSM", "make_sparse_gp_ssm", "sparse_gp_fit", "sparse_gp_init",
    "sparse_gp_predict", "sparse_gp_predict_mean_jac", "sparse_gp_refit",
    "sparse_gp_update_data",
]
