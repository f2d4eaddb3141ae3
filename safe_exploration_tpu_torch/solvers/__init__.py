"""L3 safe-MPC solvers: the single-instance NLP, the lane-major GN-AL SQP,
the CEM planners and the SafeMPC state machines."""
