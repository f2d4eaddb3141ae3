"""L3 safe-MPC solvers: the lane-major GN-AL SQP and the batched SafeMPC."""
