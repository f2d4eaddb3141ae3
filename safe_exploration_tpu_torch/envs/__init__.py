"""Environments: continuous-control plants as PyTorch functions."""

from safe_exploration_tpu_torch.envs.base import (
    Env,
    EnvSpec,
    box_polytope,
    env_reset,
    env_step,
    linearize_discretize,
    rk4_step,
)
from safe_exploration_tpu_torch.envs.pendulum import make_pendulum

__all__ = [
    "Env", "EnvSpec", "box_polytope", "env_reset", "env_step",
    "linearize_discretize", "rk4_step", "make_pendulum",
]
