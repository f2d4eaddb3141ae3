"""PyTorch port: the sparse (inducing-point) GP against the JAX package, on
the CPU, in f64.

  * ``sparse_gp_init`` (the even subsample and its sine spread, or a given
    Z) and ``sparse_gp_refit``: luu, lsig, alpha and vmat at 1e-10;
  * ``sparse_gp_update_data`` with and without ``replace_old``, the batch
    overflowing the buffer (JAX's clamped scatter), at 1e-10;
  * ``sparse_gp_predict``, ``sparse_gp_predict_mean_jac`` and
    ``sparse_gp_predict_full_cov`` at 1e-10; the negative ELBO and its
    gradient in the hyperparameters, the noise and Z at 1e-10;
  * ``sparse_gp_fit`` after 5 Adam steps, with and without ``opt_z``, at
    1e-8;
  * the SSM entries on a sparse model with ``z_scale`` (predict, the mean
    Jacobians, update, fit, probe points, the Lipschitz calibration) and
    the numpy bridge;
  * the f32 whitened refit at low noise stays finite where the naive
    Sigma factorization breaks (the JAX package's
    ``test_f32_refit_stable_at_low_noise_scale``, on its data).

Shapes are small (40 points in a buffer of 48, m 16, d_in 3, e 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import sparse_gp as jsp  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm  # noqa: E402
from safe_exploration_tpu_torch.models import sparse_gp as tsp  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm  # noqa: E402
from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    sparse_gpssm_from_numpy,
    sparse_gpssm_to_numpy,
)
from test_torch_bridge import (  # noqa: E402,F401
    jax_region,
    jax_sparse_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)

KT = ("rbf", "rbf")
N, N_MAX, M = 40, 48, 16
FACTORS = ("luu", "lsig", "alpha", "vmat")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (n, 3)) * [0.3, 1.0, 1.0]
    y = 0.05 * np.sin(2.0 * x[:, :2]) + 0.01 * rng.standard_normal((n, 2))
    return x, y


def _params(seed=1):
    rng = np.random.default_rng(seed)
    return [{"log_lengthscales": rng.normal(0.0, 0.3, 3),
             "log_sf": np.array(-1.0 + 0.2 * d)} for d in range(2)]


def _both(fn_j, fn_t, params):
    return (fn_j(tuple({k: jnp.asarray(v) for k, v in p.items()}
                       for p in params)),
            fn_t(tuple({k: _t(v) for k, v in p.items()} for p in params)))


@pytest.fixture(scope="module")
def sgps():
    """The same sparse GP built by both packages (default Z)."""
    x, y = _data(N)
    return _both(
        lambda p: jsp.sparse_gp_init(KT, jnp.asarray(x), jnp.asarray(y),
                                     n_max=N_MAX, n_inducing=M,
                                     log_noise=-3.0, params=p),
        lambda p: tsp.sparse_gp_init(KT, _t(x), _t(y), n_max=N_MAX,
                                     n_inducing=M, log_noise=-3.0, params=p),
        _params())


def _assert_state(tg, jg, tol):
    for f in FACTORS + ("z", "x", "y", "mask"):
        assert _rel(getattr(tg, f).numpy(), getattr(jg, f)) < tol, f
    assert tg.head == int(jg.head)


def test_init_refit_and_update_match_jax(sgps):
    """``sparse_gp_init`` with the default Z (even subsample + 1e-2 sine
    spread; more inducing points than data, so the subsample repeats rows)
    and with a given Z, then ``sparse_gp_update_data`` of 12 points at head
    40 of a 48-row buffer, with and without ``replace_old`` (4 points wrap
    around, or are dropped, the clamped scatter keeping the last slot's old
    row): the state at 1e-10."""
    jg, tg = sgps
    _assert_state(tg, jg, 1e-10)
    x, y = _data(12)
    _assert_state(*reversed(_both(
        lambda p: jsp.sparse_gp_init(KT, jnp.asarray(x), jnp.asarray(y),
                                     n_max=16, n_inducing=M, log_noise=-2.5,
                                     params=p),
        lambda p: tsp.sparse_gp_init(KT, _t(x), _t(y), n_max=16,
                                     n_inducing=M, log_noise=-2.5, params=p),
        _params(3))), 1e-10)
    x, y = _data(N)
    z = np.random.default_rng(5).uniform(-1.0, 1.0, (M, 3))
    _assert_state(*reversed(_both(
        lambda p: jsp.sparse_gp_init(KT, jnp.asarray(x), jnp.asarray(y),
                                     n_max=N_MAX, n_inducing=M,
                                     z=jnp.asarray(z), params=p),
        lambda p: tsp.sparse_gp_init(KT, _t(x), _t(y), n_max=N_MAX,
                                     n_inducing=M, z=_t(z), params=p),
        _params())), 1e-10)
    xn, yn = _data(12, seed=4)
    for replace_old in (True, False):
        ju = jsp.sparse_gp_update_data(jg, jnp.asarray(xn), jnp.asarray(yn),
                                       replace_old=replace_old)
        tu = tsp.sparse_gp_update_data(tg, _t(xn), _t(yn),
                                       replace_old=replace_old)
        _assert_state(tu, ju, 1e-10)
        assert int(tu.n_points) == int(ju.n_points)


def test_predictions_and_elbo_match_jax(sgps):
    """``sparse_gp_predict``, ``sparse_gp_predict_mean_jac`` and
    ``sparse_gp_predict_full_cov`` at 8 inputs, the negative ELBO and its
    gradient in (params, log_noise, Z), at 1e-10."""
    jg, tg = sgps
    zq = np.random.default_rng(7).uniform(-0.8, 0.8, (8, 3))
    tout = tsp.sparse_gp_predict(tg, _t(zq))
    tout2 = tsp.sparse_gp_predict_mean_jac(tg, _t(zq))
    jout = [np.stack(o) for o in zip(*(
        jsp.sparse_gp_predict(jg, jnp.asarray(z)) for z in zq))]
    jout2 = [np.stack(o) for o in zip(*(
        jsp.sparse_gp_predict_mean_jac(jg, jnp.asarray(z)) for z in zq))]
    for t, j in zip(tout + tout2, jout + jout2):
        assert _rel(t.numpy(), j) < 1e-10
    jm, jc = jsp.sparse_gp_predict_full_cov(jg, jnp.asarray(zq))
    tm, tc = tsp.sparse_gp_predict_full_cov(tg, _t(zq))
    assert _rel(tm.numpy(), jm) < 1e-10 and _rel(tc.numpy(), jc) < 1e-10
    assert _rel(torch.diagonal(tc, dim1=-2, dim2=-1).T.numpy(),
                tout[1].numpy()) < 1e-10

    def jloss(theta):
        (params, log_noise), z = theta
        return jsp.sparse_gp_elbo(params, log_noise, jg, z=z)

    jtheta = ((jg.params, jg.log_noise), jg.z)
    jval, jgrad = jit_once(jax.value_and_grad(jloss), jtheta)(jtheta)
    leaves = [t.clone().requires_grad_(True) for t in
              [p[k] for p in tg.params for k in sorted(p)]
              + [tg.log_noise, tg.z]]
    params = ({"log_lengthscales": leaves[0], "log_sf": leaves[1]},
              {"log_lengthscales": leaves[2], "log_sf": leaves[3]})
    tval = tsp.sparse_gp_elbo(params, leaves[4], tg, z=leaves[5])
    tgrad = torch.autograd.grad(tval, leaves)
    assert abs(tval.item() - float(jval)) <= 1e-10 * abs(float(jval))
    for t, j in zip(tgrad, jax.tree.leaves(jgrad)):
        assert _rel(t.numpy(), j) < 1e-10


def test_fit_matches_jax(sgps):
    """5 Adam steps (optax's order of operations) on the bound plus the
    prior on the hyperparameters, with and without ``opt_z``, then a
    refit, at 1e-8."""
    jg, tg = sgps
    for opt_z in (True, False):
        jf = jit_once(lambda g: jsp.sparse_gp_fit(g, iters=5, opt_z=opt_z),
                      jg)(jg)
        tf = tsp.sparse_gp_fit(tg, iters=5, opt_z=opt_z)
        _assert_state(tf, jf, 1e-8)
        assert _rel(tf.log_noise.numpy(), jf.log_noise) < 1e-8
        for d in range(2):
            for k in ("log_lengthscales", "log_sf"):
                assert _rel(tf.params[d][k].numpy(), jf.params[d][k]) < 1e-8
        assert (tf.z.numpy() != tg.z.numpy()).any() == opt_z


@pytest.fixture(scope="module")
def ssms():
    """A sparse GP-SSM with input scales, built by both packages."""
    x, y = _data(N)
    scale = np.array([0.5, 2.0, 1.0])
    lm = np.array([0.05, 0.05])
    js = jsp.make_sparse_gp_ssm(
        KT, jnp.asarray(x[:, :2]), jnp.asarray(x[:, 2:]), jnp.asarray(y),
        n_max=N_MAX, n_inducing=M, l_mu=jnp.asarray(lm),
        l_sigma=jnp.asarray(lm), log_noise=-3.0, z_scale=jnp.asarray(scale))
    ts = tsp.make_sparse_gp_ssm(
        KT, _t(x[:, :2]), _t(x[:, 2:]), _t(y), n_max=N_MAX, n_inducing=M,
        l_mu=_t(lm), l_sigma=_t(lm), log_noise=-3.0, z_scale=_t(scale))
    return js, ts


def test_ssm_entries_match_jax(ssms):
    """Predict and the mean Jacobians (the z_scale chain rule), the noise,
    the point count, the probe points, the bucketed view, ssm_update,
    ssm_fit, calibrate_lipschitz and the numpy bridge on a sparse model."""
    from safe_exploration_tpu.envs import make_pendulum as jax_pendulum
    from safe_exploration_tpu_torch.envs import make_pendulum

    js, ts = ssms
    _assert_state(ts.sgp, js.sgp, 1e-10)
    rng = np.random.default_rng(9)
    xq, uq = rng.uniform(-0.5, 0.5, (4, 2)), rng.uniform(-1.0, 1.0, (4, 1))
    tout = tssm.ssm_predict_jac(ts, _t(xq), _t(uq))
    jout = [np.stack(o) for o in zip(*(
        jssm.ssm_predict_jac(js, jnp.asarray(xq[i]), jnp.asarray(uq[i]))
        for i in range(4)))]
    for t, j in zip(tout + tssm.ssm_predict(ts, _t(xq), _t(uq)),
                    jout + jout[:2]):
        assert _rel(t.numpy(), j) < 1e-10
    assert _rel(tssm.ssm_noise_var(ts).numpy(), jssm.ssm_noise_var(js)) < 1e-12
    assert int(tssm.ssm_n_points(ts)) == int(jssm.ssm_n_points(js)) == N
    assert _rel(tssm.ssm_probe_points(ts).numpy(),
                jssm.ssm_probe_points(js)) < 1e-12
    assert tssm.ssm_bucketed(ts) is ts
    xn, yn = _data(5, seed=6)
    ju = jssm.ssm_update(js, jnp.asarray(xn[:, :2]), jnp.asarray(xn[:, 2:]),
                         jnp.asarray(yn))
    tu = tssm.ssm_update(ts, _t(xn[:, :2]), _t(xn[:, 2:]), _t(yn))
    _assert_state(tu.sgp, ju.sgp, 1e-10)
    jf = jit_once(lambda s: jssm.ssm_fit(s, iters=3), js)(js)
    tf = tssm.ssm_fit(ts, iters=3)
    _assert_state(tf.sgp, jf.sgp, 1e-8)
    # calibrate_lipschitz over the inducing inputs (raw units) and the
    # operating region's probes, on the JAX runner's region draws, against
    # the jitted JAX calibration (as the runner's, |z - z_i|^2 is exactly 0
    # at an inducing input, as in the port)
    n_region = 96
    spec = jax_pendulum(dtype=jnp.float64).spec
    jc = jit_once(lambda s: jssm.calibrate_lipschitz(s, spec,
                                                     n_region=n_region), js)(js)
    tc = tssm.calibrate_lipschitz(
        ts, make_pendulum(dtype=torch.float64, device="cpu").spec,
        n_region=n_region, draws=jax_region(n_region))
    assert _rel(tc.l_mu.numpy(), jc.l_mu) < 1e-9
    assert _rel(tc.l_sigma.numpy(), jc.l_sigma) < 1e-9
    # the numpy bridge both ways
    arrays = jax_sparse_gpssm_to_numpy(js)
    tb = sparse_gpssm_from_numpy(arrays, KT, device="cpu")
    back = sparse_gpssm_to_numpy(tb)
    for k, v in arrays.items():
        if k == "params":
            for pb, pa in zip(back[k], v):
                for name in pa:
                    np.testing.assert_array_equal(pb[name], pa[name])
        else:
            np.testing.assert_array_equal(back[k], v)
    assert tb.sgp.head == N and tb.sgp.n_inducing == M


def test_f32_refit_stable_at_low_noise_scale():
    """The whitened refit in f32 at config 4's conditioning (2,048 pendulum
    transitions, m 64, log noise -4, log sf -3, on the JAX test's draws):
    the naive Sigma = Kuu + Kuf Kuf^T / s2 factorization breaks there, the
    whitened factors stay finite, the variance positive and below the
    prior, and the mean within 5e-3 of the f64 model's."""
    from safe_exploration_tpu.envs import env_step as jax_env_step
    from safe_exploration_tpu.envs import (
        linearize_discretize as jax_linearize,
        make_pendulum as jax_pendulum,
    )
    from safe_exploration_tpu_torch.models.kernels import gram

    env = jax_pendulum(dtype=jnp.float64)
    a, b = jax_linearize(env)
    key = jax.random.PRNGKey(0)
    n_data = 2048
    xs = (jax.random.uniform(key, (n_data, 2), jnp.float64, -1.0, 1.0)
          * jnp.asarray([0.3, 1.0]))
    us = jax.random.uniform(jax.random.fold_in(key, 1), (n_data, 1),
                            jnp.float64, -1.0, 1.0)
    _, x_next = jax.vmap(lambda x, u: jax_env_step(env, key, x, u))(xs, us)
    resid = np.asarray(x_next - (xs @ a.T + us @ b.T))
    xs, us = np.asarray(xs), np.asarray(us)

    def build(dtype):
        def t(v):
            return torch.tensor(v, dtype=dtype)

        s = tsp.make_sparse_gp_ssm(
            KT, t(xs), t(us), t(resid), n_max=n_data, n_inducing=64,
            l_mu=t([0.05, 0.05]), l_sigma=t([0.02, 0.02]), log_noise=-4.0)
        params = tuple({**p, "log_sf": t(-3.0)} for p in s.sgp.params)
        return tsp.sparse_gp_refit(s.sgp.replace(params=params))

    g32 = build(torch.float32)
    eye = torch.eye(64)
    noise_var = torch.exp(2.0 * g32.log_noise[0])
    kuu = gram("rbf", g32.params[0], g32.z, g32.z) + tsp._JITTER * eye
    kuf = gram("rbf", g32.params[0], g32.z, g32.x) * g32.mask[None, :]
    sigma = kuu + (kuf @ kuf.T) / noise_var
    naive, info = torch.linalg.cholesky_ex(sigma + tsp._JITTER * eye)
    recon = float(torch.max(torch.abs(torch.nan_to_num(naive @ naive.T)
                                      - sigma)) / torch.max(torch.abs(sigma)))
    assert (int(info) != 0 or bool(torch.isnan(naive).any())
            or bool((torch.diagonal(naive) <= tsp._JITTER ** 0.5 * 1e-2).any())
            or recon > 1e-3)
    for name in FACTORS:
        assert bool(torch.isfinite(getattr(g32, name)).all()), name
    g64 = build(torch.float64)
    zq = np.random.default_rng(9).uniform(-0.5, 0.5, (16, 3))
    m32, v32 = tsp.sparse_gp_predict(g32, torch.tensor(zq, dtype=torch.float32))
    m64, _ = tsp.sparse_gp_predict(g64, _t(zq))
    kzz = float(torch.exp(2.0 * g32.params[0]["log_sf"]))
    assert bool((v32 > 0).all()) and bool((v32 <= kzz * (1 + 1e-3)).all())
    np.testing.assert_allclose(m32.double().numpy(), m64.numpy(), atol=5e-3)
