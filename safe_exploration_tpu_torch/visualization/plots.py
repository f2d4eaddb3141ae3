"""2-D ellipsoid / tube / safety-bound plotting — port of
``safe_exploration_tpu/visualization/plots.py``.

The functions take tensors (on any device) or arrays and draw from their
CPU numpy copies. matplotlib is imported inside each plot function, so
importing this module (and the package) never imports it; a machine
without matplotlib runs everything but the plots.
"""

from __future__ import annotations

import numpy as np

__all__ = ["plot_ellipsoid_2d", "plot_safety_bounds", "plot_tube_2d"]


def _np(a) -> np.ndarray:
    """A tensor's (detached, CPU) or an array's values as numpy."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _ellipse_points(p, q, n_points: int = 100):
    """Boundary points of E(p, Q) in 2-D: p + Q^{1/2} [cos t, sin t]."""
    p, q = _np(p), _np(q)
    w, v = np.linalg.eigh(q)
    sqrt_q = v @ np.diag(np.sqrt(np.maximum(w, 0.0))) @ v.T
    t = np.linspace(0.0, 2.0 * np.pi, n_points)
    circle = np.stack([np.cos(t), np.sin(t)])
    return (sqrt_q @ circle).T + p


def plot_ellipsoid_2d(p, q, ax=None, *, color="C0", alpha=0.3, n_points=100,
                      **kw):
    """Draw the 2-D ellipsoid E(p, Q) on ``ax`` (created if None)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    pts = _ellipse_points(p, q, n_points)
    ax.fill(pts[:, 0], pts[:, 1], color=color, alpha=alpha, **kw)
    ax.plot(pts[:, 0], pts[:, 1], color=color, lw=1.0)
    return ax


def plot_safety_bounds(h_mat, h_vec, ax=None, *, dims=(0, 1), color="k",
                       **kw):
    """Draw the axis-aligned part of the polytope {Hx <= h} restricted to two
    state dims (box constraints render as a rectangle)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    lo, hi = {}, {}
    for row, bound in zip(_np(h_mat), _np(h_vec)):
        nz = np.nonzero(row)[0]
        if len(nz) == 1 and nz[0] in dims:
            d = int(nz[0])
            if row[d] > 0:
                hi[d] = min(hi.get(d, np.inf), bound / row[d])
            else:
                lo[d] = max(lo.get(d, -np.inf), bound / row[d])
    if set(dims) <= set(lo) & set(hi):
        x0, x1 = lo[dims[0]], hi[dims[0]]
        y0, y1 = lo[dims[1]], hi[dims[1]]
        ax.plot([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0],
                color=color, ls="--", **kw)
    return ax


def plot_tube_2d(p_traj, q_traj, ax=None, *, dims=(0, 1), x_traj=None,
                 color="C0", **kw):
    """Draw a predicted ellipsoid tube (and optionally a realized trajectory)
    projected onto two state dimensions."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots()
    d = list(dims)
    p_traj, q_traj = _np(p_traj), _np(q_traj)
    for p, q in zip(p_traj, q_traj):
        plot_ellipsoid_2d(p[d], q[np.ix_(d, d)], ax=ax, color=color, **kw)
    ax.plot(p_traj[:, d[0]], p_traj[:, d[1]], color=color, marker=".",
            lw=1.0)
    if x_traj is not None:
        x_traj = _np(x_traj)
        ax.plot(x_traj[:, d[0]], x_traj[:, d[1]], color="C3", marker="x",
                lw=1.0, label="realized")
    return ax
