"""PyTorch port: the GP's large-matrix refit and its negative log marginal
likelihood against the JAX package, on the CPU, in f64: ``gp_refit`` at
n_max 1040 (the large-matrix tier, ``cholesky_hbm``'s plain version) with
chol, beta and K^-1 at 1e-9, ``gp_nll``'s value and gradient at 1e-10, and
a NaN where the factor fails instead of an error.

Split from tests/test_torch_episode.py, whose helpers it takes, so that
each file's test count (pytest-xdist hands files out by it) places it well
in the tier-1 run's schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import gp as jgp  # noqa: E402
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from test_torch_bridge import one_torch_thread  # noqa: E402,F401
from test_torch_episode import (  # noqa: E402,F401
    KT,
    _assert_factors,
    _gps,
    _params,
    _rel,
    _t,
)


def test_gp_refit_hbm_tier_matches_jax():
    """n_max 1040 > 1024 routes the port's refit to the left-looking tier
    (plain version on the CPU); 1,000 points, identity on the rest."""
    jg, tg = _gps(1000, 1040)
    _assert_factors(tg, jg, 1e-9)
    eye = np.eye(40)
    np.testing.assert_array_equal(tg.chol[:, 1000:, 1000:].numpy(),
                                  np.broadcast_to(eye, (2, 40, 40)))


def test_gp_nll_value_and_gradient_match_jax():
    params, log_noise = _params()
    jg, tg = _gps(18, 24)
    jp = tuple({k: jnp.asarray(v) for k, v in p.items()} for p in params)
    jval, (jgp_, jgn) = jax.jit(jax.value_and_grad(jgp.gp_nll, argnums=(
        0, 1)))(jp, jnp.asarray(log_noise), jg)
    tp = tuple({k: _t(v).requires_grad_(True) for k, v in p.items()}
               for p in params)
    tn = _t(log_noise).requires_grad_(True)
    val = tgp.gp_nll(tp, tn, tg)
    val.backward()
    assert abs(float(val) - float(jval)) <= 1e-10 * abs(float(jval))
    for d in range(2):
        for k in ("log_lengthscales", "log_sf"):
            assert _rel(tp[d][k].grad.numpy(), jgp_[d][k]) < 1e-10, (d, k)
    assert _rel(tn.grad.numpy(), jgn) < 1e-10


def test_gp_nll_nan_instead_of_raising():
    """An indefinite Gram (negative noise variance through a huge negative
    jitter would be needed; here a duplicated point with no noise): the
    factorization fails and the NLL is NaN, as JAX's, not an exception."""
    x = np.array([[0.1, 0.2, 0.3]] * 4 + [[0.5, 0.1, -0.2]])
    y = np.zeros((5, 2))
    tg = tgp.gp_init(KT, _t(x), _t(y), n_max=8, log_noise=-3.0)
    params = tuple({"log_lengthscales": _t(np.zeros(3)),
                    "log_sf": _t(np.array(12.0))} for _ in range(2))
    val = tgp.gp_nll(params, _t(np.array([-40.0, -40.0])), tg)
    jg = jgp.gp_init(KT, jnp.asarray(x), jnp.asarray(y), n_max=8,
                     log_noise=-3.0)
    jval = jax.jit(jgp.gp_nll)(
        tuple({k: jnp.asarray(v.numpy()) for k, v in p.items()}
              for p in params), jnp.asarray([-40.0, -40.0]), jg)
    assert np.isnan(float(jval)) and np.isnan(float(val))
