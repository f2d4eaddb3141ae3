"""safe_exploration_tpu_torch — the PyTorch/CUDA port of safe_exploration_tpu.

The JAX package (``safe_exploration_tpu``) is the reference; this package
keeps its module layout and names so each function has an obvious
counterpart, and runs on an NVIDIA GPU (Hopper, ``sm_90a``):

  ops/linalg.py          DARE / LQR / ZOH discretization
  ops/ellipsoid.py,      ellipsoid calculus and the Lipschitz remainder boxes
  ops/lipschitz.py
  ops/kernels/           hand-written CUDA kernels, each beside its plain
                         PyTorch version, built with nvcc on first use: the GP
                         refit (masked RBF Gram, blocked Cholesky, blocked
                         TRSM) and the lane CEM (fused lane GP posterior,
                         whole-tube CEM scorer)
  envs/                  plants (pendulum) and the Env substrate
  models/                RBF kernels, the padded GP, the GP state-space model
  reachability/          one- and multi-step ellipsoid reachability, the
                         ellipsoid-vs-polytope safety margins
  solvers/               tracking and exploration costs, the safe-MPC NLP
                         (single instance, GN or exact Hessian), the lane-major
                         Gauss-Newton AL SQP, the portable and the lane-major
                         constrained CEM, the SafeMPC state machines
  runtime/config.py      ExperimentConfig + build_experiment
  runtime/               the CLI's runners (main.py): episodic, batch, serve
                         (ServeController), uncertainty, exploration

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
device given and no GPU present they raise instead of quietly running on the
CPU. Importing the package builds nothing and imports neither Triton nor JAX.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["resolve_device"]

# --- numerics policy: IEEE f32 matmuls ---------------------------------------
#
# The safety tube is computed through matmuls (RBF distances, the posterior
# variance quadratic form kzz - kv K^-1 kv). Reduced-precision products (TF32
# keeps ~10 mantissa bits) inflate the posterior variances and with them the
# tubes, which costs feasibility. The JAX package pins "highest" for the same
# reason; the port pins full f32 for matmuls and convolutions alike.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA; asking for CUDA on a machine without a GPU raises
    rather than falling back to the CPU. Pass ``"cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU (what the tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested (device=None means CUDA) but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU"
        )
    return dev
