"""L2 safety engine: ellipsoidal reachability of GP dynamics and the
ellipsoid-vs-polytope safety margins."""

from safe_exploration_tpu_torch.reachability.onestep import (
    multistep_reachability,
    onestep_reachability,
    onestep_reachability_point,
)
from safe_exploration_tpu_torch.reachability.safety import (
    is_ellipsoid_inside_polytope,
    lin_ellipsoid_safety_distance,
    sample_inside_polytope,
    trajectory_inside_ellipsoids,
    verify_trajectory_safety,
)

__all__ = [
    "onestep_reachability", "onestep_reachability_point",
    "multistep_reachability", "lin_ellipsoid_safety_distance",
    "is_ellipsoid_inside_polytope", "trajectory_inside_ellipsoids",
    "verify_trajectory_safety", "sample_inside_polytope",
]
