"""PyTorch port: the GP hyperparameter fit and the Lipschitz estimates against
the JAX package, on the CPU: 10 steps of ``gp_fit`` (Adam in optax's order)
with hyperparameters at 1e-8; ``estimate_lipschitz`` off data at 1e-8,
``calibrate_lipschitz`` on JAX's region probes, and the estimate at the
training inputs against the jitted JAX one in f64 and f32.

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
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    gpssm_from_numpy,
)
from test_torch_bridge import (  # noqa: E402,F401
    jax_gpssm_to_numpy,
    jax_region as _jax_region,
    one_torch_thread,
)
from test_torch_episode import (  # noqa: E402,F401
    F64,
    KT,
    N_REGION,
    _assert_factors,
    _data,
    _gps,
    _params,
    _rel,
    _t,
    pendulum,
)


def test_gp_fit_matches_jax():
    params, _ = _params()
    jg, tg = _gps(18, 24, params)
    jf = jgp.gp_fit(jg, iters=10)
    tf = tgp.gp_fit(tg, iters=10)
    for d in range(2):
        for k in ("log_lengthscales", "log_sf"):
            assert _rel(tf.params[d][k].numpy(), jf.params[d][k]) < 1e-8
    assert _rel(tf.log_noise.numpy(), jf.log_noise) < 1e-8
    _assert_factors(tf, jf, 1e-8)
    assert int(tf.n_points) == int(jf.n_points) == 18


def test_lipschitz_estimates_match_jax(pendulum):
    """estimate_lipschitz at off-data points against the JAX estimate
    (jitted) at 1e-8, and calibrate_lipschitz as that estimate over the
    training buffer plus the region probes of JAX's PRNGKey(0). At training
    inputs: :func:`test_lipschitz_at_training_inputs_matches_jitted_jax`."""
    jexp, texp = pendulum
    x, y = _data(20, seed=3)
    spec = jexp["env"].spec
    jssm = jssm_mod.make_gp_ssm(
        KT, jnp.asarray(x[:, :2]), jnp.asarray(x[:, 2:]), jnp.asarray(y),
        n_max=24, l_mu=jexp["l_mu"], l_sigma=jexp["l_sigma"], log_noise=-3.0,
        z_scale=jnp.concatenate([spec.norm_x, spec.norm_u]))
    jssm = jssm.replace(gp=jax.jit(jgp.gp_fit, static_argnames="iters")(
        jssm.gp, iters=5))
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(jssm), KT, device="cpu")
    z = np.random.default_rng(4).uniform(-1, 1, (40, 3)) * [0.5, 2.0, 1.0]
    je = jax.jit(jssm_mod.estimate_lipschitz)(jssm, jnp.asarray(z))
    te = tssm_mod.estimate_lipschitz(tssm, _t(z))
    assert _rel(te.l_mu.numpy(), je.l_mu) < 1e-8
    assert _rel(te.l_sigma.numpy(), je.l_sigma) < 1e-8
    region = tssm_mod.lipschitz_probe_set(
        texp["env"].spec, n_samples=N_REGION, draws=_jax_region(N_REGION))
    assert _rel(region.numpy(), jssm_mod.lipschitz_probe_set(
        jexp["env"].spec, jax.random.PRNGKey(0), N_REGION)) < 1e-15
    tc = tssm_mod.calibrate_lipschitz(tssm, texp["env"].spec,
                                      draws=_jax_region(N_REGION))
    ref = tssm_mod.estimate_lipschitz(
        tssm, torch.cat([tssm_mod.ssm_probe_points(tssm), region]),
        factor=1.2)
    assert torch.equal(tc.l_mu, ref.l_mu)
    assert torch.equal(tc.l_sigma, ref.l_sigma)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("float64", 1e-10)])
def test_lipschitz_at_training_inputs_matches_jitted_jax(dtype, tol):
    """estimate_lipschitz probed at the 20-point model's own buffer
    (``ssm_probe_points``) against jitted JAX, in each precision. There
    |z - x_i|^2 is exactly 0 in both (the cross term formed by the norms'
    own arithmetic; the pendulum's z_scale round trip is exact), so the
    floor's derivative is 1/2 in both and the Hessians agree. l_sigma is
    held in f64 only: at a training input the f32 variance sf2 - kv^T K^-1
    kv is a cancellation whose rounding follows each library's summation
    order, and the std's gradient divides by it (2.6e-2 relative apart on
    this model)."""
    from safe_exploration_tpu_torch.models.kernels import _sq_dists

    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "float64": (F64, torch.float64)}[dtype]
    jexp = jax_build(JaxConfig(), dtype=jdt)
    spec = jexp["env"].spec
    x, y = _data(20, seed=3)
    jssm = jssm_mod.make_gp_ssm(
        KT, jnp.asarray(x[:, :2], jdt), jnp.asarray(x[:, 2:], jdt),
        jnp.asarray(y, jdt), n_max=24, l_mu=jexp["l_mu"],
        l_sigma=jexp["l_sigma"], log_noise=-3.0,
        z_scale=jnp.concatenate([spec.norm_x, spec.norm_u]))
    jssm = jssm.replace(gp=jax.jit(jgp.gp_fit, static_argnames="iters")(
        jssm.gp, iters=5))
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(jssm), KT, device="cpu",
                            dtype=tdt)
    probes = tssm_mod.ssm_probe_points(tssm)
    assert torch.equal(probes / tssm.z_scale, tssm.gp.x)
    ls = torch.exp(tssm.gp.params[0]["log_lengthscales"])
    d2 = _sq_dists(probes / tssm.z_scale / ls, tssm.gp.x / ls)
    assert torch.all(torch.diagonal(d2) == 0.0)
    je = jax.jit(jssm_mod.estimate_lipschitz)(
        jssm, jssm_mod.ssm_probe_points(jssm))
    te = tssm_mod.estimate_lipschitz(tssm, probes)
    assert _rel(te.l_mu.numpy(), je.l_mu) < tol
    if dtype == "float64":
        assert _rel(te.l_sigma.numpy(), je.l_sigma) < tol
