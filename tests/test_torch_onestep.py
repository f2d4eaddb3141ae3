"""PyTorch port: the GP mean Jacobians, one- and multi-step reachability and
the trajectory safety check against the JAX package, f64 on the CPU (1e-10
relative), with and without input scaling, batched forms against JAX's
``vmap``.

Split from tests/test_torch_reachability.py, whose fixtures it takes, so
that each file's test count (pytest-xdist hands files out by it) places
it well in the tier-1 run's schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.envs import (  # noqa: E402
    make_pendulum as jax_pendulum,
)
from safe_exploration_tpu.models import gp as jgp  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.reachability import onestep as jos  # noqa: E402
from safe_exploration_tpu.reachability import safety as jsafe  # noqa: E402
from safe_exploration_tpu_torch.envs import make_pendulum  # noqa: E402
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.reachability import (  # noqa: E402
    onestep as tos,
)
from safe_exploration_tpu_torch.reachability import (  # noqa: E402
    safety as tsafe,
)
from test_torch_bridge import one_torch_thread  # noqa: E402,F401
from test_torch_reachability import (  # noqa: E402,F401
    _psd,
    _rel,
    _t,
    models,
    prior,
)


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
