"""PyTorch port: ellipsoids and the safety margins against the JAX package,
f64 on the CPU, and the fixtures (a GP-SSM with and without input scaling,
the pendulum's prior) that tests/test_torch_lipschitz.py and
tests/test_torch_onestep.py hold the Lipschitz remainders and the one- and
multi-step reachability with.

Every function is held to its JAX counterpart at 1e-10 relative, with and
without input scaling, and the batched forms (leading sample dimension, the
portable CEM's layout) to JAX's ``vmap``. The tests on the JAX-fitted
cfg1 golden state are in tests/test_torch_sqp_lanes.py, which builds that
state once. The reachability tests are split over three files so that
each file's test count (pytest-xdist hands files out by it, largest
first) places it well in the tier-1 run's schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.envs import linearize_discretize as jax_lin  # noqa: E402
from safe_exploration_tpu.envs import make_pendulum as jax_pendulum  # noqa: E402
from safe_exploration_tpu.models import gp as jgp  # noqa: E402
from safe_exploration_tpu.models import make_gp_ssm as jax_make_ssm  # noqa: E402
from safe_exploration_tpu.ops import ellipsoid as jel  # noqa: E402
from safe_exploration_tpu.ops.linalg import dlqr as jax_dlqr  # noqa: E402
from safe_exploration_tpu.reachability import safety as jsafe  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.ops import ellipsoid as tel  # noqa: E402
from safe_exploration_tpu_torch.reachability import safety as tsafe  # noqa: E402
from test_torch_bridge import jax_gpssm_to_numpy, one_torch_thread  # noqa: E402,F401

KT = ("rbf", "rbf")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _psd(rng, n, lead=()):
    a = rng.standard_normal(lead + (n, n))
    return a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(n)


@pytest.fixture(scope="module")
def models():
    """A JAX GP-SSM on pendulum-like data, with and without input scaling,
    and its port (same arrays)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, (14, 2)) * [0.3, 1.0]
    u = rng.uniform(-1.0, 1.0, (14, 1))
    y = 0.02 * np.sin(3.0 * np.concatenate([x, u], 1) @ rng.normal(size=(3, 2)))
    out = {}
    for z_scale in (True, False):
        j = jax_make_ssm(
            KT, jnp.asarray(x), jnp.asarray(u), jnp.asarray(y), n_max=16,
            l_mu=jnp.full((2,), 0.05), l_sigma=jnp.full((2,), 0.02),
            log_noise=-4.0,
            z_scale=jnp.asarray([0.5, 2.0, 1.0]) if z_scale else None)
        params = tuple({**p, "log_sf": jnp.asarray(-1.5)} for p in j.gp.params)
        j = j.replace(gp=jgp.gp_refit(j.gp.replace(params=params)))
        out[z_scale] = (j, gpssm_from_numpy(jax_gpssm_to_numpy(j), KT,
                                            device="cpu"))
    return out


@pytest.fixture(scope="module")
def prior():
    env = jax_pendulum(dtype=jnp.float64)
    a, b = jax_lin(env)
    k_fb = -jax_dlqr(a, b, jnp.eye(2), jnp.eye(1))[0]
    return np.asarray(a), np.asarray(b), np.asarray(k_fb)


# ------------------------------------------------------------- ellipsoids


def test_ellipsoid_ops_match_jax():
    rng = np.random.default_rng(1)
    p1, p2 = rng.standard_normal((2, 5, 3))
    q1, q2 = _psd(rng, 3, (5,)), _psd(rng, 3, (5,))
    ref = jax.vmap(jel.sum_two_ellipsoids)(*(jnp.asarray(v)
                                             for v in (p1, q1, p2, q2)))
    out = tel.sum_two_ellipsoids(_t(p1), _t(q1), _t(p2), _t(q2))
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-10
    # a degenerate side stays finite, as in the JAX package
    p, q = tel.sum_two_ellipsoids(_t(p1[0]), torch.zeros(3, 3,
                                                         dtype=torch.float64),
                                  _t(p2[0]), _t(q2[0]))
    jp, jq = jel.sum_two_ellipsoids(jnp.asarray(p1[0]), jnp.zeros((3, 3)),
                                    jnp.asarray(p2[0]), jnp.asarray(q2[0]))
    assert torch.isfinite(q).all() and _rel(q.numpy(), jq) < 1e-10
    ub = rng.uniform(0.1, 1.0, (4, 3))
    assert _rel(tel.ellipsoid_from_rectangle(_t(ub)).numpy(),
                jax.vmap(jel.ellipsoid_from_rectangle)(jnp.asarray(ub))) < 1e-10
    pts = rng.standard_normal((7, 3))
    assert _rel(tel.distance_to_center(_t(pts), _t(p1[0]), _t(q1[0])).numpy(),
                jel.distance_to_center(jnp.asarray(pts), jnp.asarray(p1[0]),
                                       jnp.asarray(q1[0]))) < 1e-10


def test_sample_inside_ellipsoid_stays_inside():
    """The draws differ from jax.random's, so the contract is checked: the
    samples are inside (distance_to_center <= 1) and reproducible from the
    generator's seed."""
    rng = np.random.default_rng(2)
    p, q = _t(rng.standard_normal(3)), _t(_psd(rng, 3))
    s1 = tel.sample_inside_ellipsoid(torch.Generator().manual_seed(4), 500, p, q)
    s2 = tel.sample_inside_ellipsoid(torch.Generator().manual_seed(4), 500, p, q)
    assert s1.shape == (500, 3) and torch.equal(s1, s2)
    d = tel.distance_to_center(s1, p, q)
    assert float(d.max()) <= 1.0 + 1e-9 and float(d.max()) > 0.5


# ------------------------------------------------------------------ safety


def test_safety_functions_match_jax():
    rng = np.random.default_rng(7)
    env = jax_pendulum(dtype=jnp.float64)
    spec = env.spec
    h_mat, h_vec = np.asarray(spec.h_mat_obs), np.asarray(spec.h_obs)
    p = rng.uniform(-0.6, 0.6, (6, 2))
    q = 0.02 * _psd(rng, 2, (6,))
    ref = jax.vmap(lambda pp, qq: jsafe.lin_ellipsoid_safety_distance(
        pp, qq, jnp.asarray(h_mat), jnp.asarray(h_vec)))(jnp.asarray(p),
                                                         jnp.asarray(q))
    out = tsafe.lin_ellipsoid_safety_distance(_t(p), _t(q), _t(h_mat),
                                              _t(h_vec))
    assert _rel(out.numpy(), ref) < 1e-10
    inside = tsafe.is_ellipsoid_inside_polytope(_t(p), _t(q), _t(h_mat),
                                                _t(h_vec)).numpy()
    np.testing.assert_array_equal(inside, np.all(np.asarray(ref) <= 0, -1))
    assert inside.any() and not inside.all()
    x = p + rng.uniform(-0.3, 0.3, p.shape)
    np.testing.assert_array_equal(
        tsafe.trajectory_inside_ellipsoids(_t(x), _t(p), _t(q)).numpy(),
        np.asarray(jsafe.trajectory_inside_ellipsoids(
            jnp.asarray(x), jnp.asarray(p), jnp.asarray(q))))
    pts, ok = tsafe.sample_inside_polytope(
        torch.Generator().manual_seed(1), 200, _t(h_mat), _t(h_vec),
        _t([0.8, 2.5]))
    assert pts.shape == (200, 2) and (pts.abs() <= _t([0.8, 2.5])).all()
    np.testing.assert_array_equal(
        ok.numpy(), np.all(pts.numpy() @ h_mat.T - h_vec <= 0.0, -1))


