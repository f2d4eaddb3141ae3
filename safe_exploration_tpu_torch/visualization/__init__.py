"""Visualization helpers — port of ``safe_exploration_tpu/visualization``:
2-D ellipsoid, safety-bound and tube plots (matplotlib, imported only when
a plot is drawn)."""

from safe_exploration_tpu_torch.visualization.plots import (
    plot_ellipsoid_2d,
    plot_safety_bounds,
    plot_tube_2d,
)

__all__ = ["plot_ellipsoid_2d", "plot_safety_bounds", "plot_tube_2d"]
