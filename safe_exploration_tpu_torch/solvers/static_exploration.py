"""Box bounds of a polytope — the part of
``safe_exploration_tpu/solvers/static_exploration.py`` the Lipschitz
calibration needs (the static exploration planner itself is not ported:
ROADMAP Queue 1, item 12)."""

from __future__ import annotations

import numpy as np

__all__ = ["polytope_box_bounds"]


def polytope_box_bounds(h_mat, h_vec, fallback: float = 10.0):
    """Per-dimension box bounds (lo, hi) as numpy arrays, implied by the
    axis-aligned rows of the polytope {x : H x <= h}; a dimension no such row
    bounds gets +-``fallback``. Accepts tensors or arrays."""
    h_mat = np.asarray(h_mat.cpu() if hasattr(h_mat, "cpu") else h_mat)
    h_vec = np.asarray(h_vec.cpu() if hasattr(h_vec, "cpu") else h_vec)
    n = h_mat.shape[1]
    lo = np.full((n,), -fallback)
    hi = np.full((n,), fallback)
    for r in range(h_mat.shape[0]):
        nz = np.nonzero(np.abs(h_mat[r]) > 1e-12)[0]
        if len(nz) != 1:
            continue
        i, c = int(nz[0]), h_mat[r, nz[0]]
        bound = h_vec[r] / c
        if c > 0:
            hi[i] = min(hi[i], bound)
        else:
            lo[i] = max(lo[i], bound)
    return lo, hi
