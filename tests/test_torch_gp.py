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
from safe_exploration_tpu.models import ssm as jssm  # noqa: E402
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm  # noqa: E402
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


def test_gp_shrink_to_bucket_matches_jax():
    j, t = _both_init(n_max=128, n=40)
    jb, tb = jgp.gp_shrink_to_bucket(j), tgp.gp_shrink_to_bucket(t)
    assert tb.n_max == jb.n_max == 64
    _assert_factors(jb, tb)


def test_masked_gram_matches_jax_and_the_batched_plain_kernel():
    from safe_exploration_tpu_torch.ops.kernels import gram_plain

    x, _, params, log_noise = _data()
    mask = (np.arange(20) < 15).astype(np.float64)
    noise = np.exp(2.0 * log_noise)
    batched = gram_plain(_t(x), _t(mask),
                         _t([p["log_lengthscales"] for p in params]),
                         _t([p["log_sf"] for p in params]),
                         _t(log_noise)).numpy()
    for d, p in enumerate(params):
        ours = tgp._masked_gram("rbf", {k: _t(v) for k, v in p.items()},
                                _t(x), _t(mask), _t(noise[d])).numpy()
        ref = jgp._masked_gram("rbf", {k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), jnp.asarray(mask),
                               jnp.asarray(noise[d]))
        assert _rel(ours, ref) < 1e-12
        assert _rel(batched[d], ours) < 1e-12


def test_gp_predict_matches_jax():
    j, t = _both_init()
    z = np.random.default_rng(3).uniform(-1.0, 1.0, (11, 3))
    jm, jv = jgp.gp_predict_batch(j, jnp.asarray(z))
    tm, tv = tgp.gp_predict(t, _t(z))
    assert _rel(tm.numpy(), jm) < 1e-9
    assert _rel(tv.numpy(), jv) < 1e-9


def test_ssm_update_with_input_scaling_matches_jax():
    """make_gp_ssm on normalized inputs, then ssm_update and the bucketed
    view: factors, buffer and the latent posterior agree."""
    x, y, _, _ = _data(24)
    xs, us = x[:, :2], x[:, 2:]
    z_scale = np.array([0.5, 2.0, 1.0])
    kw = dict(n_max=64, log_noise=-3.0)
    j = jssm.make_gp_ssm(KT, jnp.asarray(xs), jnp.asarray(us), jnp.asarray(y),
                         l_mu=jnp.full(2, 0.5), l_sigma=jnp.full(2, 0.25),
                         z_scale=jnp.asarray(z_scale), **kw)
    t = tssm.make_gp_ssm(KT, _t(xs), _t(us), _t(y), l_mu=_t([0.5, 0.5]),
                         l_sigma=_t([0.25, 0.25]), z_scale=_t(z_scale), **kw)
    _assert_factors(j.gp, t.gp)
    xn, un = xs[:6] + 0.05, us[:6] - 0.1
    yn = y[:6] * 1.1
    j = jssm.ssm_update(j, jnp.asarray(xn), jnp.asarray(un), jnp.asarray(yn))
    t = tssm.ssm_update(t, _t(xn), _t(un), _t(yn))
    _assert_factors(j.gp, t.gp)
    jb, tb = jssm.ssm_bucketed(j), tssm.ssm_bucketed(t)
    assert tb.gp.n_max == jb.gp.n_max == 32
    probe = np.random.default_rng(4).uniform(-0.5, 0.5, (9, 3))
    jm, jv = jgp.gp_predict_batch(jb.gp, jnp.asarray(probe / z_scale))
    tm, tv = tssm.ssm_predict(tb, _t(probe[:, :2]), _t(probe[:, 2:]))
    assert _rel(tm.numpy(), jm) < 1e-9
    assert _rel(tv.numpy(), jv) < 1e-9


def test_precision_ff_is_not_ported():
    _, t = _both_init()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgp.gp_refit(t.replace(precision="ff"))
