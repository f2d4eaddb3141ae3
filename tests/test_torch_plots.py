"""PyTorch port: the plots (``visualization/plots.py``) on the CPU:
``_ellipse_points`` equals the JAX package's on arrays and on tensors, and
the three plots draw on the Agg backend."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.visualization import plots as jplots  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    build_experiment,
)
from safe_exploration_tpu_torch.visualization import plots  # noqa: E402

F64 = torch.float64


def test_ellipse_points_match_jax():
    rng = np.random.default_rng(4)
    m = rng.standard_normal((2, 2))
    q = m @ m.T + 0.1 * np.eye(2)
    p = rng.standard_normal(2)
    want = jplots._ellipse_points(p, q, 50)
    np.testing.assert_array_equal(plots._ellipse_points(p, q, 50), want)
    np.testing.assert_array_equal(
        plots._ellipse_points(torch.tensor(p), torch.tensor(q), 50), want)


def test_plots_draw_on_agg(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    exp = build_experiment(CONFIGS["pendulum_episode"], dtype=F64,
                           device="cpu")
    spec = exp["env"].spec
    fig, ax = plt.subplots()
    p = torch.tensor([[0.0, 0.0], [0.05, 0.02], [0.08, 0.03]], dtype=F64)
    q = 0.01 * torch.eye(2, dtype=F64).expand(3, 2, 2)
    plots.plot_tube_2d(p, q, ax=ax, x_traj=p + 0.01)
    plots.plot_safety_bounds(spec.h_mat_obs, spec.h_obs, ax=ax)
    plots.plot_ellipsoid_2d(p[1], q[1], ax=ax, color="C2")
    assert len(ax.lines) == 3 + 1 + 1 + 1 + 1     # 3 + 1 ellipses, tube,
    fig.savefig(tmp_path / "tube.png")             # realized, bounds
    plt.close(fig)
    assert (tmp_path / "tube.png").stat().st_size > 0
