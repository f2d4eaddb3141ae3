"""PyTorch port: the slice end to end against the JAX package, f64 on the CPU.

The prior (a, b, k_fb), the plant step and reset, the normalizations, the
tracking cost, the dual shift, and then the closed
loop the port carries: build_experiment -> make_ssm -> get_action_batch ->
plant step -> ssm_update -> get_action_batch, at n_max 32, 16 data points,
B 8, on both sides from the same numpy data and noise. Controls, feasible
flags and every SafeMPCState field must agree (flags and counters exactly,
floats at 1e-4 relative). The JAX step is jit-compiled once and reused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.envs import base as jax_base  # noqa: E402
from safe_exploration_tpu.envs.base import _integrate as jax_integrate  # noqa: E402
from safe_exploration_tpu.models.ssm import (  # noqa: E402
    ssm_bucketed as jax_bucketed,
    ssm_update as jax_update,
)
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu.solvers.costs import (  # noqa: E402
    tracking_cost as jax_tracking_cost,
)
from safe_exploration_tpu.solvers.sqp import shift_duals as jax_shift  # noqa: E402
from safe_exploration_tpu_torch.envs import base, env_step  # noqa: E402
from safe_exploration_tpu_torch.models.ssm import (  # noqa: E402
    ssm_bucketed,
    ssm_update,
)
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.solvers.sqp import shift_duals  # noqa: E402
from test_torch_bridge import jit_once, one_torch_thread  # noqa: E402,F401

B = 8
N_DATA = 16
CFG = dict(solver="sqp", n_safe=3, n_max=32, sqp_outer=2, sqp_inner=1,
           sqp_polish=1, sqp_rescue=0, l_mu=0.05, l_sigma=0.02, log_noise=-4.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def exps():
    return (jax_build(JaxConfig(**CFG), dtype=jnp.float64),
            build_experiment(ExperimentConfig(**CFG), dtype=torch.float64,
                             device="cpu"))


def _jax_step(jexp, x, u, noise):
    """The JAX plant step with explicit standard-normal noise."""
    env = jexp["env"]
    u_app = jnp.clip(u, env.spec.u_min, env.spec.u_max)
    x_next = jax.vmap(lambda xx, uu: jax_integrate(env, xx, uu))(x, u_app)
    return x_next + env.spec.plant_noise * noise


def test_env_step_matches_jax(exps):
    jexp, texp = exps
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.3, 0.3, (5, 2))
    u = rng.uniform(-1.5, 1.5, (5, 1))          # some beyond the torque limit
    noise = rng.standard_normal((5, 2))
    u_app, xn = env_step(texp["env"], _t(x), _t(u), noise=_t(noise))
    np.testing.assert_array_equal(u_app.numpy(), np.clip(u, -1.0, 1.0))
    jx = _jax_step(jexp, jnp.asarray(x), jnp.asarray(u), jnp.asarray(noise))
    assert _rel(xn.numpy(), jx) < 1e-12


def test_env_reset_and_normalization_match_jax(exps):
    jexp, texp = exps
    z = np.random.default_rng(3).standard_normal((4, 2))
    x0 = base.env_reset(texp["env"], batch=(4,), noise=_t(z))
    js = jexp["env"].spec
    np.testing.assert_allclose(x0.numpy(), np.asarray(js.init_m + js.init_std
                                                      * z), rtol=1e-15)
    ts = texp["env"].spec
    for name in ("normalize_state", "unnormalize_state"):
        ours = getattr(base, name)(ts, x0).numpy()
        ref = getattr(jax_base, name)(js, jnp.asarray(x0.numpy()))
        np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-15)
    u = _t([[0.3], [-0.7]])
    for name in ("normalize_control", "unnormalize_control"):
        ref = getattr(jax_base, name)(js, jnp.asarray(u.numpy()))
        np.testing.assert_allclose(getattr(base, name)(ts, u).numpy(),
                                   np.asarray(ref), rtol=1e-15)


def test_tracking_cost_matches_jax(exps):
    jexp, texp = exps
    rng = np.random.default_rng(6)
    p, q, v = (rng.standard_normal((3, 2)), rng.standard_normal((3, 2, 2)),
               rng.random((3, 2)))
    k = rng.standard_normal((3, 1))
    ours = texp["cost_fn"](_t(p), _t(q), _t(v), _t(k))
    ref = jax_tracking_cost(jexp["env"].spec.target)(
        *(jnp.asarray(a) for a in (p, q, v, k)))
    assert abs(float(ours) - float(ref)) <= 1e-12 * abs(float(ref))


def test_shift_duals_matches_jax():
    lam = np.random.default_rng(1).standard_normal((B, 3 * 4 + 4))
    ours = shift_duals(_t(lam), n_safe=3, n_obs=4).numpy()
    ref = jax.vmap(lambda la: jax_shift(la, 3, 4))(jnp.asarray(lam))
    np.testing.assert_array_equal(ours, np.asarray(ref))


def _assert_state(ts, js):
    for f in ("plan_idx", "n_fail"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    for f in ("k_ff_plan", "p_plan", "warm_mean", "lam"):
        ref = np.asarray(getattr(js, f))
        if np.max(np.abs(ref)) > 0:
            assert _rel(getattr(ts, f).numpy(), ref) < 1e-4, f
        else:
            np.testing.assert_array_equal(getattr(ts, f).numpy(), ref)


def test_two_closed_loop_steps_match_jax(exps):
    jexp, texp = exps
    rng = np.random.default_rng(2)
    xs = rng.uniform(-1.0, 1.0, (N_DATA, 2)) * [0.3, 1.0]
    us = rng.uniform(-1.0, 1.0, (N_DATA, 1))
    noise0 = rng.standard_normal((N_DATA, 2))
    x_next = np.asarray(_jax_step(jexp, jnp.asarray(xs), jnp.asarray(us),
                                  jnp.asarray(noise0)))
    a, b = np.asarray(jexp["a"]), np.asarray(jexp["b"])
    resid = x_next - (xs @ a.T + us @ b.T)
    jssm = jexp["make_ssm"](jax.random.PRNGKey(0), jnp.asarray(xs),
                            jnp.asarray(us), jnp.asarray(resid))
    tssm = texp["make_ssm"](_t(xs), _t(us), _t(resid))
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(tssm.gp, f).numpy(), getattr(jssm.gp, f)) < 1e-9

    x0 = rng.uniform(-1.0, 1.0, (B, 2)) * [0.15, 0.4]
    x0[::4] *= 3.0                       # a few lanes near the boundary
    jstate, tstate = jexp["init_state_batch"](B), texp["init_state_batch"](B)
    jx, tx = jnp.asarray(x0), _t(x0)
    step = jit_once(jexp["get_action_batch"], jstate, jax_bucketed(jssm), jx)
    feas_seen = []
    for k in range(2):
        ju, jstate, jinfo = step(jstate, jax_bucketed(jssm), jx)
        tu, tstate, tinfo = texp["get_action_batch"](tstate, ssm_bucketed(tssm),
                                                     tx)
        np.testing.assert_array_equal(tinfo["feasible"].numpy(),
                                      np.asarray(jinfo["feasible"]))
        assert _rel(tu.numpy(), ju) < 1e-4
        _assert_state(tstate, jstate)
        feas_seen.append(np.asarray(jinfo["feasible"]))
        if k == 0:
            noise = rng.standard_normal((B, 2))
            jx1 = _jax_step(jexp, jx, ju, jnp.asarray(noise))
            _, tx1 = env_step(texp["env"], tx, tu, noise=_t(noise))
            assert _rel(tx1.numpy(), jx1) < 1e-4
            jres = jx1 - (jx @ jexp["a"].T + ju @ jexp["b"].T)
            tres = tx1 - (tx @ texp["a"].T + tu @ texp["b"].T)
            jssm = jax_update(jssm, jx, ju, jres)
            tssm = ssm_update(tssm, tx, tu, tres)
            for f in ("chol", "beta", "kinv"):
                assert _rel(getattr(tssm.gp, f).numpy(),
                            getattr(jssm.gp, f)) < 1e-6, f
            jx, tx = jx1, tx1
    assert int(tssm.gp.mask.sum()) == N_DATA + B
    assert np.concatenate(feas_seen).any()
