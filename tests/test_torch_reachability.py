"""PyTorch port: ellipsoids, Lipschitz remainders, one- and multi-step
reachability and the safety margins against the JAX package, f64 on the CPU.

Every function is held to its JAX counterpart at 1e-10 relative, with and
without input scaling, and the batched forms (leading sample dimension, the
portable CEM's layout) to JAX's ``vmap``. The tests on the JAX-fitted
cfg1 golden state are in tests/test_torch_sqp_lanes.py, which builds that
state once.
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
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.ops import ellipsoid as jel  # noqa: E402
from safe_exploration_tpu.ops import lipschitz as jlip  # noqa: E402
from safe_exploration_tpu.ops.linalg import dlqr as jax_dlqr  # noqa: E402
from safe_exploration_tpu.reachability import onestep as jos  # noqa: E402
from safe_exploration_tpu.reachability import safety as jsafe  # noqa: E402
from safe_exploration_tpu_torch.envs import make_pendulum  # noqa: E402
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.ops import ellipsoid as tel  # noqa: E402
from safe_exploration_tpu_torch.ops import lipschitz as tlip  # noqa: E402
from safe_exploration_tpu_torch.reachability import onestep as tos  # noqa: E402
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


# ---------------------------------------------------------------- Lipschitz


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_max_eig_psd_product_matches_jax(n):
    rng = np.random.default_rng(n)
    m = _psd(rng, n, (6,)) @ _psd(rng, n, (6,))
    ref = jax.vmap(jlip.max_eig_psd_product)(jnp.asarray(m))
    assert _rel(tlip.max_eig_psd_product(_t(m)).numpy(), ref) < 1e-10


def test_remainder_overapproximations_match_jax(prior):
    _, _, k_fb = prior
    rng = np.random.default_rng(3)
    q = _psd(rng, 2, (5,))
    l_mu, l_sigma = np.array([0.05, 0.07]), np.array([0.02, 0.03])
    ref = jax.vmap(lambda qq: jlip.compute_remainder_overapproximations(
        qq, jnp.asarray(k_fb), jnp.asarray(l_mu), jnp.asarray(l_sigma)))(
            jnp.asarray(q))
    out = tlip.compute_remainder_overapproximations(
        _t(q), _t(k_fb), _t(l_mu), _t(l_sigma))
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-10


# ----------------------------------------------------- GP mean Jacobians


@pytest.mark.parametrize("z_scale", [True, False])
def test_mean_jacobians_match_jax(models, z_scale):
    j, t = models[z_scale]
    z = np.random.default_rng(5).uniform(-0.5, 0.5, (6, 3))
    ref = jax.vmap(lambda zz: jgp.gp_predict_mean_jac(j.gp, zz))(
        jnp.asarray(z))
    for o, r in zip(tgp.gp_predict_mean_jac(t.gp, _t(z)), ref):
        assert _rel(o.numpy(), r) < 1e-10
    ref = jax.vmap(lambda zz: jssm_mod.ssm_predict_jac(j, zz[:2], zz[2:]))(
        jnp.asarray(z))
    out = tssm_mod.ssm_predict_jac(t, _t(z[:, :2]), _t(z[:, 2:]))
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-10
    assert _rel(tssm_mod.ssm_noise_var(t).numpy(),
                jssm_mod.ssm_noise_var(j)) < 1e-12


# ------------------------------------------------------------- reachability


@pytest.mark.parametrize("z_scale", [True, False])
def test_onestep_and_multistep_match_jax(models, prior, z_scale):
    j, t = models[z_scale]
    a, b, k_fb = prior
    rng = np.random.default_rng(6)
    p = rng.uniform(-1.0, 1.0, (4, 2)) * [0.15, 0.4]
    k_ff = 0.1 * rng.standard_normal((4, 1))
    q = 1e-3 * _psd(rng, 2, (4,))
    ja, jb, jk = jnp.asarray(a), jnp.asarray(b), jnp.asarray(k_fb)
    ref = jax.vmap(lambda pp, kk: jos.onestep_reachability_point(
        j, pp, kk, ja, jb, 2.0))(jnp.asarray(p), jnp.asarray(k_ff))
    out = tos.onestep_reachability_point(t, _t(p), _t(k_ff), _t(a), _t(b), 2.0)
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-10
    ref = jax.vmap(lambda pp, qq, kk: jos.onestep_reachability(
        j, pp, qq, kk, jk, ja, jb, 2.0))(jnp.asarray(p), jnp.asarray(q),
                                         jnp.asarray(k_ff))
    out = tos.onestep_reachability(t, _t(p), _t(q), _t(k_ff), _t(k_fb), _t(a),
                                   _t(b), 2.0)
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-10
    k_all = 0.05 * rng.standard_normal((4, 5, 1))
    kfb_all = np.tile(k_fb[None], (5, 1, 1))
    for q0 in (None, q):
        ref = jax.vmap(lambda pp, kk, qq: jos.multistep_reachability(
            j, pp, kk, jnp.asarray(kfb_all), ja, jb, 2.0, q0=qq),
            in_axes=(0, 0, None if q0 is None else 0))(
                jnp.asarray(p), jnp.asarray(k_all),
                None if q0 is None else jnp.asarray(q0))
        out = tos.multistep_reachability(t, _t(p), _t(k_all), _t(kfb_all),
                                         _t(a), _t(b), 2.0,
                                         q0=None if q0 is None else _t(q0))
        for o, r in zip(out, ref):
            assert o.shape == r.shape
            assert _rel(o.numpy(), r) < 1e-10


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


def test_verify_trajectory_safety_matches_jax_with_its_draws(prior):
    a, b, k_fb = prior
    jenv = jax_pendulum(dtype=jnp.float64)
    tenv = make_pendulum(dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(8)
    x0 = np.array([0.1, -0.2])
    k_ff = 0.05 * rng.standard_normal((5, 1))
    kfb_all = np.tile(k_fb[None], (5, 1, 1))
    # the noiseless plant's centers, the last two moved off the trajectory
    from safe_exploration_tpu.envs.base import _integrate

    p, x = [], jnp.asarray(x0)
    for t in range(5):
        x = _integrate(jenv, x, jnp.asarray(k_ff[t]))
        p.append(np.asarray(x))
    p = np.stack(p) + np.array([[0.0, 0.0]] * 3 + [[0.05, 0.2]] * 2)
    q = np.tile(np.diag([1e-3, 1e-2])[None], (5, 1, 1))
    key = jax.random.PRNGKey(3)
    ref = jsafe.verify_trajectory_safety(
        jenv, key, jnp.asarray(x0), jnp.asarray(k_ff), jnp.asarray(kfb_all),
        jnp.asarray(p), jnp.asarray(q))
    draws = np.stack([np.asarray(jax.random.normal(k, (2,), jnp.float64))
                      for k in jax.random.split(key, 5)])
    out = tsafe.verify_trajectory_safety(
        tenv, None, _t(x0), _t(k_ff), _t(kfb_all), _t(p), _t(q),
        noise=_t(draws))
    assert bool(out[0]) == bool(ref[0])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    assert np.asarray(ref[1]).any() and not np.asarray(ref[1]).all()
