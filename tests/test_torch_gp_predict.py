"""PyTorch port: the GP's bucketed views, its masked Gram (against the
batched plain kernel too), its predictions, the SSM update with input
scaling and the unported float-float precision against the JAX package, in
f64 on the CPU (factors at 1e-9 relative).

Split from tests/test_torch_gp.py, whose helpers it takes, so that each
file's test count (pytest-xdist hands files out by it) places it well in
the tier-1 run's schedule.
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
from test_torch_gp import (  # noqa: E402,F401
    KT,
    _assert_factors,
    _both_init,
    _data,
    _rel,
    _t,
)


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
