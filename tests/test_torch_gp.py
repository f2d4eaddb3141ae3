"""PyTorch port: the GP model and the GP state-space model against the JAX
package, in f64 on the CPU (the refit runs through the kernels' plain
versions there).

Factors (chol, beta, kinv) are held at 1e-9 relative. The tests on the
JAX-fitted cfg1 golden state are in tests/test_torch_sqp_lanes.py, which
builds that state once.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import gp as jgp  # noqa: E402
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from test_torch_bridge import one_torch_thread  # noqa: E402,F401

KT = ("rbf", "rbf")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _data(n=20, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3))
    y = 0.1 * np.sin(3.0 * x[:, :2]) + 1e-3 * rng.standard_normal((n, 2))
    params = [{"log_lengthscales": rng.normal(-0.3, 0.2, 3),
               "log_sf": np.asarray(-1.0 - 0.5 * d)} for d in range(2)]
    return x, y, params, np.array([-3.0, -2.8])


def _both_init(n_max=32, n=20):
    x, y, params, log_noise = _data(n)
    j = jgp.gp_init(KT, jnp.asarray(x), jnp.asarray(y), n_max=n_max,
                    log_noise=jnp.asarray(log_noise),
                    params=tuple({k: jnp.asarray(v) for k, v in p.items()}
                                 for p in params))
    t = tgp.gp_init(KT, _t(x), _t(y), n_max=n_max, log_noise=_t(log_noise),
                    params=tuple({k: _t(v) for k, v in p.items()}
                                 for p in params))
    return j, t


def _assert_factors(j, t, tol=1e-9):
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(t, f).numpy(), getattr(j, f)) < tol, f
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert int(t.head) == int(j.head)


def test_gp_init_matches_jax():
    j, t = _both_init()
    _assert_factors(j, t)


def test_gp_refit_after_hyperparameter_change_matches_jax():
    j, t = _both_init()
    jp = tuple({**p, "log_sf": p["log_sf"] + 0.7} for p in j.params)
    tp = tuple({**p, "log_sf": p["log_sf"] + 0.7} for p in t.params)
    _assert_factors(jgp.gp_refit(j.replace(params=jp)),
                    tgp.gp_refit(t.replace(params=tp)))


@pytest.mark.parametrize("replace_old", [True, False])
def test_gp_update_data_matches_jax(replace_old):
    """Two appends of 8 to a 32-slot buffer holding 20: the second one wraps
    the ring (replace_old) or drops the overflow (not replace_old)."""
    j, t = _both_init()
    rng = np.random.default_rng(7)
    for _ in range(2):
        xn = rng.uniform(-1.0, 1.0, (8, 3))
        yn = 0.1 * np.cos(xn[:, :2])
        j = jgp.gp_update_data(j, jnp.asarray(xn), jnp.asarray(yn),
                               replace_old=replace_old)
        t = tgp.gp_update_data(t, _t(xn), _t(yn), replace_old=replace_old)
        _assert_factors(j, t)
        np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), rtol=0,
                                   atol=0)


