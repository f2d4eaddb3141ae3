"""PyTorch port: BASELINE config 2, the cart-pole (n_s = 4, n_u = 1, a GP of
e = 4 outputs over d = 5 inputs, a joint safety + performance trajectory),
against the JAX package on the CPU in f64.

The JAX-fitted cfg2 golden state (tools/regen_goldens.build_problem
("cartpole", 5, 10): 16 points, n_max 32, the fit and the Lipschitz
estimate) is built once for the module and carried across as numpy
arrays; each JAX program is built once:

  * the env: ``a``, ``b``, ``k_fb`` at 1e-10, the dynamics at 1e-12;
  * ``multi_step_propagation``, both methods, at 1e-9;
  * the array-form tube: ``_max_eig_lanes_array`` and
    ``_sum_two_ellipsoids_q_array`` at n = 3, 4, 6 (1e-10),
    ``_rollout_lanes_array`` and the array ``_dist_lanes`` on a shared and
    on a per-lane model (1e-9), and the port's tube at n_s = 2 (the array
    form, which every state dimension runs) against the JAX package's
    scalar unroll and array form (1e-9);
  * the performance trajectory: the packed rollout with its perf blocks and
    ``_cost_lanes`` over n_perf and r (1e-9);
  * the lane models at e = 4, d = 5: ``lane_predict`` with its Jacobian,
    ``lane_append_point``, the stacked fit and ``calibrate_lipschitz``
    (1e-8) and the numpy bridge;
  * one ``solve_safempc_lanes`` call at n_s = 4, n_perf 6, r_shared 2 with
    feasible and infeasible lanes (the lane-SQP gates).

The cfg2 golden's gates, the single-instance NLP, the portable CEM with
n_perf, the slice as a whole (``run_experiment`` on ``cartpole_batch_sqp``
fed the JAX run's draws) and the CLI are in
tests/test_torch_cartpole_solvers.py, which takes this file's fixture and
helpers: split so that each file's test count (pytest-xdist hands files
out by it) places it well in the tier-1 run's schedule. The ``slow``
full-width fleet checks stay here.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import gp_lanes as jgl  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.reachability import propagation as jprop  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu.solvers import sqp_lanes as jl  # noqa: E402
from safe_exploration_tpu.solvers.sqp import SqpConfig as JaxSqpConfig  # noqa: E402
from safe_exploration_tpu_torch.envs import make_cartpole  # noqa: E402
from safe_exploration_tpu_torch.models import gp_lanes as tgl  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.models.convert import (  # noqa: E402
    gpssm_from_numpy,
    gpssm_to_numpy,
)
from safe_exploration_tpu_torch.reachability import propagation as tprop  # noqa: E402
from safe_exploration_tpu_torch.runtime import batch as tbatch  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
)
from safe_exploration_tpu_torch.solvers import sqp_lanes as tl  # noqa: E402
from safe_exploration_tpu_torch.solvers.sqp import SqpConfig  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    jax_batch_draws,
    jax_gpssm_to_numpy,
    jax_region,
    jit_once,
    one_torch_thread,
)

F64 = jnp.float64
KT = ("rbf",) * 4
N_S, N_U = 4, 1
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(_REPO, "tests", "goldens", "cfg2_cartpole_h10.npz")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture(scope="module")
def golden():
    """The JAX-fitted cfg2 golden state, its experiment, probes, x0 and
    evaluation controls, with the port's experiment and model."""
    sys.path.insert(0, os.path.join(_REPO, "tools"))
    try:
        from regen_goldens import build_problem
    finally:
        sys.path.pop(0)
    jexp, jssm, probes, x0, k_ff_eval = build_problem("cartpole", 5, 10)
    arrays = jax_gpssm_to_numpy(jssm)
    texp = build_experiment(dataclasses.replace(
        ExperimentConfig(), **{k: v for k, v in dataclasses.asdict(
            jexp["cfg"]).items()}), dtype=torch.float64, device="cpu")
    return dict(jexp=jexp, texp=texp, jssm=jssm, arrays=arrays,
                tssm=gpssm_from_numpy(arrays, KT, device="cpu"),
                probes=np.asarray(probes), x0=np.asarray(x0),
                k_ff_eval=np.asarray(k_ff_eval))


def _consts(jexp):
    k_fb = np.asarray(jexp["k_fb"])
    s_lift = np.concatenate([np.eye(N_S), k_fb], axis=0)
    return k_fb, np.asarray(jexp["a"]), np.asarray(jexp["b"]), \
        s_lift.T @ s_lift


def _polys(spec):
    return [np.asarray(v) for v in (spec.h_mat_obs, spec.h_obs,
                                    spec.h_mat_safe, spec.h_safe)]


def _lane_x0(b, seed, scale=0.05):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (N_S, b)) * scale


# ------------------------------------------------------------------ the env


def test_cartpole_env_matches_jax(golden):
    """a, b and the LQR gain k_fb at 1e-10; the dynamics at random states
    at 1e-12; the rail boxes (8 rows each) and norm_x = hi_o equal."""
    jexp, texp = golden["jexp"], golden["texp"]
    for k in ("a", "b", "k_fb"):
        assert _rel(texp[k].numpy(), jexp[k]) < 1e-10, k
    jspec, tspec = jexp["env"].spec, texp["env"].spec
    for f in ("h_mat_safe", "h_safe", "h_mat_obs", "h_obs", "norm_x",
              "norm_u", "u_min", "u_max", "init_std", "plant_noise"):
        np.testing.assert_array_equal(getattr(tspec, f).numpy(),
                                      np.asarray(getattr(jspec, f)), f)
    assert tspec.h_mat_obs.shape == (8, 4) and tspec.h_safe.shape == (8,)
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.8, 0.8, (7, 4))
    u = rng.uniform(-5.0, 5.0, (7, 1))
    jd = jax.vmap(jexp["env"].dynamics)(jnp.asarray(x), jnp.asarray(u))
    td = make_cartpole(dtype=torch.float64, device="cpu").dynamics(_t(x),
                                                                  _t(u))
    assert _rel(td.numpy(), jd) < 1e-12


# -------------------------------------------------------------- propagation


@pytest.mark.parametrize("method", ["taylor", "mean_equivalent"])
def test_multi_step_propagation_matches_jax(golden, method):
    """Three initial states through 6 open-loop stages: p, Sigma and var at
    1e-9 against the JAX package's scan, vmapped."""
    jexp, jssm, tssm = golden["jexp"], golden["jssm"], golden["tssm"]
    rng = np.random.default_rng(1)
    p0 = rng.uniform(-0.05, 0.05, (3, N_S))
    u = rng.uniform(-0.3, 0.3, (3, 6, N_U))
    ref = jax.vmap(lambda p, uu: jprop.multi_step_propagation(
        jssm, p, uu, jexp["a"], jexp["b"], method=method))(
            jnp.asarray(p0), jnp.asarray(u))
    out = tprop.multi_step_propagation(tssm, _t(p0), _t(u), _t(jexp["a"]),
                                       _t(jexp["b"]), method=method)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert _rel(o.numpy(), r) < 1e-9


# ------------------------------------------------------- the array-form tube


@pytest.mark.parametrize("n", [3, 4, 6])
def test_array_eig_and_minkowski_sum_match_jax(n):
    rng = np.random.default_rng(n)
    a = rng.standard_normal((9, n, n))
    m1 = np.einsum("bij,bkj->ikb", a, a)                 # PSD lane matrices
    a2 = rng.standard_normal((9, n, n))
    m2 = np.einsum("bij,bkj->ikb", a2, a2)
    assert _rel(tl._max_eig_lanes_array(_t(m1)).numpy(),
                jl._max_eig_lanes_array(jnp.asarray(m1))) < 1e-10
    prod = np.einsum("ikb,kjb->ijb", m1, m2)
    assert _rel(tl._max_eig_lanes_array(_t(prod)).numpy(),
                jl._max_eig_lanes_array(jnp.asarray(prod))) < 1e-10
    assert _rel(tl._sum_two_ellipsoids_q_array(_t(m1), _t(m2)).numpy(),
                jl._sum_two_ellipsoids_q_array(jnp.asarray(m1),
                                               jnp.asarray(m2))) < 1e-10


def _lane_models(golden):
    """The golden model stacked into 3 lanes by both packages, then one
    lockstep append of a per-lane transition (so the lanes differ)."""
    jssm, tssm = golden["jssm"], golden["tssm"]
    rng = np.random.default_rng(7)
    x = rng.uniform(-0.05, 0.05, (3, N_S))
    u = rng.uniform(-0.3, 0.3, (3, N_U))
    y = 0.01 * rng.standard_normal((3, N_S))
    jm = jax.jit(jgl.lane_append_point)(
        jgl.lane_stack_ssm(jssm, 3), jnp.asarray(x), jnp.asarray(u),
        jnp.asarray(y))
    tm = tgl.lane_append_point(tgl.lane_stack_ssm(tssm, 3), _t(x), _t(u),
                               _t(y))
    return jm, tm


@pytest.mark.parametrize("which", ["shared", "per_lane"])
def test_rollout_lanes_array_matches_jax(golden, which):
    """The packed array-form tube (p, Q, var over 5 stages) and its margins
    at 1e-9, on the shared model and on per-lane models."""
    jexp, texp = golden["jexp"], golden["texp"]
    jm, tm = ((golden["jssm"], golden["tssm"]) if which == "shared"
              else _lane_models(golden))
    k_fb, a, b, bmat = _consts(jexp)
    x0 = _lane_x0(3, 2)
    u = 0.1 * np.random.default_rng(3).standard_normal((5, 3))
    jy = jl._rollout_lanes_array(jm, jnp.asarray(u), jnp.asarray(x0),
                                 *(jnp.asarray(v) for v in (k_fb, a, b)),
                                 JaxSqpConfig(n_safe=5), jnp.asarray(bmat))
    ty = tl._rollout_lanes_array(tm, _t(u), _t(x0),
                                 *(_t(v) for v in (k_fb, a, b)),
                                 SqpConfig(n_safe=5), _t(bmat))
    assert ty.shape == jy.shape == (5 * (4 + 16 + 4), 3)
    assert _rel(ty.numpy(), jy) < 1e-9
    polys = _polys(jexp["env"].spec)
    jd = jl._dist_lanes(jy, 5, N_S, *(jnp.asarray(v) for v in polys))
    td = tl._dist_lanes(ty, 5, N_S, *(_t(v) for v in polys))
    assert td.shape == (5 * 8 + 8, 3)
    assert _rel(td.numpy(), jd) < 1e-9


def test_array_form_matches_scalar_form_at_two_states():
    """At n_s = 2 the port's tube (the array form, which it runs at every
    state dimension) equals the JAX package's scalar unroll, what the JAX
    pendulum paths run, and its array form, at 1e-9; margins too (the JAX
    package pins its two forms to each other in tests/test_sqp_lanes.py)."""
    jexp = jax_build(JaxConfig(solver="sqp"), dtype=F64)
    exp = build_experiment(ExperimentConfig(solver="sqp"),
                           dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    z = rng.uniform(-1.0, 1.0, (20, 3)) * [0.3, 1.0, 1.0]
    y = 0.05 * np.sin(2.0 * z[:, :2])
    jssm = jexp["make_ssm"](jax.random.PRNGKey(0), jnp.asarray(z[:, :2]),
                            jnp.asarray(z[:, 2:]), jnp.asarray(y))
    jssm = jssm.replace(l_mu=jnp.full(2, 0.05), l_sigma=jnp.full(2, 0.02))
    ssm = gpssm_from_numpy(jax_gpssm_to_numpy(jssm), ("rbf", "rbf"),
                           device="cpu")
    k_fb = np.asarray(jexp["k_fb"])
    s_lift = np.concatenate([np.eye(2), k_fb], 0)
    bmat = s_lift.T @ s_lift
    x0 = rng.uniform(-1.0, 1.0, (2, 4)) * [[0.1], [0.3]]
    u = 0.1 * rng.standard_normal((4, 4))
    jargs = (jexp["k_fb"], jexp["a"], jexp["b"], JaxSqpConfig(n_safe=4),
             jnp.asarray(bmat))
    j_scalar = jl._pack_y(*jl._rollout_lanes(
        jssm, jnp.asarray(u), [jnp.asarray(row) for row in x0], *jargs))
    j_array = jl._rollout_lanes_array(jssm, jnp.asarray(u), jnp.asarray(x0),
                                      *jargs)
    ty = tl._rollout_y_lanes(ssm, _t(u), _t(x0), exp["k_fb"], exp["a"],
                             exp["b"], SqpConfig(n_safe=4), _t(bmat))
    assert _rel(ty.numpy(), j_scalar) < 1e-9
    assert _rel(ty.numpy(), j_array) < 1e-9
    spec = exp["env"].spec
    polys = (spec.h_mat_obs, spec.h_obs, spec.h_mat_safe, spec.h_safe)
    assert _rel(tl._dist_lanes(ty, 4, 2, *polys).numpy(),
                jl._dist_lanes(j_scalar, 4, 2, *(jnp.asarray(v.numpy())
                                                 for v in polys))) < 1e-9


# ------------------------------------------------- the performance trajectory


@pytest.mark.parametrize("objective", ["tracking", "exploration"])
def test_rollout_with_perf_and_cost_match_jax(golden, objective):
    """n_safe 3, n_perf 6, r 2: the packed y (tube then perf blocks) and the
    lane cost over the perf stages and u_perf_all at 1e-9."""
    jexp = golden["jexp"]
    k_fb, a, b, bmat = _consts(jexp)
    jm, tm = _lane_models(golden)
    t_len, n_perf, r = 3, 6, 2
    n_var = t_len + n_perf - r
    x0 = _lane_x0(3, 5)
    u = 0.2 * np.random.default_rng(6).standard_normal((n_var, 3))
    jcfg = JaxSqpConfig(n_safe=t_len, n_perf=n_perf, r_shared=r)
    tcfg = SqpConfig(n_safe=t_len, n_perf=n_perf, r_shared=r)
    jy = jl._rollout_y_lanes(jm, jnp.asarray(u),
                             [jnp.asarray(row) for row in x0],
                             *(jnp.asarray(v) for v in (k_fb, a, b)), jcfg,
                             jnp.asarray(bmat), r, N_U)
    ty = tl._rollout_y_lanes(tm, _t(u), _t(x0),
                             *(_t(v) for v in (k_fb, a, b)), tcfg, _t(bmat),
                             r=r)
    assert ty.shape == jy.shape == (t_len * 24 + n_perf * 8, 3)
    assert _rel(ty.numpy(), jy) < 1e-9
    target = np.full(N_S, 0.01)
    args = {"target": target} if objective == "tracking" else {}
    jc = jl._cost_lanes(objective, {k: jnp.asarray(v) for k, v in
                                    args.items()}, jy, jnp.asarray(u), t_len,
                        N_S, N_U, n_perf=n_perf, r=r)
    tc = tl._cost_lanes(objective, {k: _t(v) for k, v in args.items()}, ty,
                        _t(u), t_len, N_S, N_U, n_perf=n_perf, r=r)
    assert _rel(tc.numpy(), jc) < 1e-9


# ------------------------------------------------ lane models at e=4, d=5


def test_lane_models_at_four_outputs_match_jax(golden):
    """lane_predict with its Jacobian after one append, the unstacked
    (refitted) model, the stacked fit and the Lipschitz calibration
    (Hessians over d = 5, the max-eigenvalue step above n = 2) at 1e-8
    (the appended model's mean, ~1e-3, is a sum of beta_i k_i with |beta|
    up to ~1e2: 1.4e-9 apart); the numpy bridge round trip of the
    4-output model."""
    jexp, texp = golden["jexp"], golden["texp"]
    jm, tm = _lane_models(golden)
    z = np.concatenate([_lane_x0(3, 8), 0.2 * np.ones((1, 3))], axis=0)
    jout = jgl.lane_predict(jm, jnp.asarray(z), want_jac=True)
    tout = tgl.lane_predict(tm, _t(z), want_jac=True)
    for o, r in zip(tout, jout):
        assert o.shape == r.shape
        assert _rel(o.numpy(), r) < 1e-8
    for f in ("x", "y", "beta", "kinv"):
        assert _rel(getattr(tm.gp, f).numpy(), getattr(jm.gp, f)) < 1e-9, f
    spec = jexp["env"].spec
    n_region = 128 * (N_S + N_U)

    def fit_one(s):
        return jssm_mod.calibrate_lipschitz(jssm_mod.ssm_fit(s, iters=3),
                                            spec)

    jf = jax.jit(jax.vmap(fit_one))(jax.jit(jgl.lane_unstack_ssm)(jm))
    tf = tssm_mod.calibrate_lipschitz(
        tssm_mod.ssm_fit(tgl.lane_unstack_ssm(tm), iters=3),
        texp["env"].spec, n_region=n_region,
        draws=tuple(_t(v) for v in jax_region(n_region, F64, N_S, N_U)))
    for f in ("chol", "beta", "kinv", "log_noise"):
        assert _rel(getattr(tf.gp, f).numpy(), getattr(jf.gp, f)) < 1e-8, f
    for d in range(N_S):
        for k in ("log_lengthscales", "log_sf"):
            assert _rel(tf.gp.params[d][k].numpy(),
                        jf.gp.params[d][k]) < 1e-8, k
    for f in ("l_mu", "l_sigma"):
        assert _rel(getattr(tf, f).numpy(), getattr(jf, f)) < 1e-8, f
    arrays = golden["arrays"]
    back = gpssm_to_numpy(gpssm_from_numpy(arrays, KT, device="cpu"))
    for k, v in arrays.items():
        if k == "params":
            for pa, pb in zip(v, back[k]):
                for name in pa:
                    np.testing.assert_array_equal(pa[name], pb[name])
        else:
            np.testing.assert_array_equal(np.asarray(v), back[k])


# ---------------------------------------------------------- one lane solve


def test_solve_safempc_lanes_with_perf_matches_jax(golden):
    """The batched planner at n_s = 4, n_safe 3, n_perf 6, r_shared 2 on the
    golden model, 6 lanes, some pushed past the constraint boundary: flags
    equal and mixed; k_ff, p_traj and lambda at 1e-4, cost at 1e-3 (the
    gates of the pendulum lane-SQP test); the warm start carries the
    whole decision matrix."""
    jssm, tssm = golden["jssm"], golden["tssm"]
    kw = dict(env="cartpole", kern_types=("rbf",), solver="sqp", n_safe=3,
              n_perf=6, r_shared=2, n_max=32, sqp_outer=2, sqp_inner=1,
              sqp_polish=0, sqp_rescue=0)
    jexp = jax_build(JaxConfig(**kw), dtype=F64)
    texp = build_experiment(ExperimentConfig(**kw), dtype=torch.float64,
                            device="cpu")
    x0s = _lane_x0(6, 9, scale=0.1).T
    x0s[::3] *= 12.0         # push some lanes past the constraint boundary
    warm = np.zeros((6, 7, N_U))
    lam = np.abs(np.random.default_rng(4).normal(0.0, 0.1, (6, 3 * 8 + 8)))
    args = (jssm, jnp.asarray(x0s), jnp.asarray(warm), jnp.asarray(lam))
    jk, jf, jv, ji = jit_once(jexp["batch_planner"], *args)(*args)
    tk, tf, tv, ti = texp["batch_planner"](tssm, _t(x0s), _t(warm), _t(lam))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert np.asarray(jf).any() and not np.asarray(jf).all()
    assert tk.shape == (6, 3, 1) and ti["warm_next"].shape == (6, 7, 1)
    assert _rel(tk.numpy(), jk) < 1e-4
    assert _rel(ti["warm_next"].numpy(), ji["warm_next"]) < 1e-4
    assert _rel(ti["cost"].numpy(), ji["cost"]) < 1e-3
    assert _rel(ti["p_traj"].numpy(), ji["p_traj"]) < 1e-4
    assert _rel(ti["lam"].numpy(), ji["lam"]) < 1e-4
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                               atol=1e-9)


# ------------------------------------------ the slice's fleet (helpers, slow)

SET = ["batch_lanes=3", "n_steps=3", "n_ep=1", "n_max=48",
       "n_init_samples=32", "hyp_iters=40", "n_safe=2", "n_perf=4"]
CFG = _apply_overrides(CONFIGS["cartpole_batch_sqp"], SET)


def _recorder(monkeypatch, mod, name, store):
    fn = getattr(mod, name)

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        store.append(out)
        return out

    monkeypatch.setattr(mod, name, recorded)


def _seed0_first_data(dtype):
    """chip_smoke ``[cartpole-batch]``'s draws (a CPU generator seeded 0) at
    full width and the first fit's 40 points, in ``dtype``: (cfg, the
    port's experiment, the draws, xs, us, residuals)."""
    from safe_exploration_tpu_torch.runtime.episode import (
        collect_initial_data,
    )

    cfg = CONFIGS["cartpole_batch_sqp"]
    texp = build_experiment(cfg, dtype=dtype, device="cpu")
    d = tbatch.batch_draws(torch.Generator().manual_seed(0), texp["env"].spec,
                           batch=cfg.batch_lanes, n_ep=2, n_steps=cfg.n_steps,
                           n_init=cfg.n_init_samples, n_region=640,
                           dtype=dtype)
    data = collect_initial_data(texp["env"], cfg.n_init_samples, texp["a"],
                                texp["b"], texp["k_fb"], draws=d)
    return cfg, texp, d, *data


def _jax_first_fit(cfg, jexp, key, data):
    """The JAX runner's first model on ``data`` (numpy xs, us, residuals):
    ``ssm_fit`` then ``calibrate_lipschitz`` on its own region draws."""
    spec = jexp["env"].spec

    def fit(s):
        return jssm_mod.calibrate_lipschitz(
            jssm_mod.ssm_fit(s, iters=cfg.hyp_iters), spec)

    dt = jexp["a"].dtype
    return jax.jit(fit)(jexp["make_ssm"](
        key, *(jnp.asarray(v, dt) for v in data)))


def _jax_cli_first_data(jexp, cfg):
    """The JAX CLI's first 40 points (its own key split), as its runner
    collects them."""
    from safe_exploration_tpu.runtime.episode import (
        collect_initial_data as jax_collect,
    )

    k1 = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[0]
    return jax_collect(jexp["env"], k1, cfg.n_init_samples, jexp["a"],
                       jexp["b"], jexp["k_fb"])


@pytest.mark.slow
def test_cartpole_full_width_f32_step_and_fit_match_jax():
    """cartpole_batch_sqp at full width, on the CPU (``-m slow``: ~12 min),
    the JAX side with x64 off as its CLI runs unless f64 is named. (1) The
    JAX CLI's first model (its draws, fit and calibration) stacked into 128
    lanes, and the first step of episode 1 from its x0s through both
    packages' batch planners (n_safe 6, n_perf 10, 4 x 3 SQP), f32:
    feasibility flags equal. (2) The first fit on the draws chip_smoke's
    ``[cartpole-batch]`` makes (a CPU generator seeded 0): the port's and
    the JAX package's hyperparameters agree in f32; in f64 the fit and the
    calibration on the JAX package's region draws (l_mu, l_sigma) equal
    JAX's at 1e-8. (3) On those draws each package's own f32 first model
    (the port's calibrated on its region draws, as the fleet runs it),
    stacked into 128 lanes, and the first step from the seed-0 x0s:
    feasibility flags equal (the JAX package's f32 l_mu differs from the
    port's there, see ``test_cartpole_seed0_f32_lipschitz_matches_jax``)."""
    cfg, texp, d, txs, tus, tr = _seed0_first_data(torch.float32)
    tspec = texp["env"].spec
    lanes = cfg.batch_lanes
    f32 = jnp.float32
    seed0 = tuple(v.numpy() for v in (txs, tus, tr))
    x0_seed0 = tspec.init_m + tspec.init_std * d["reset"][0]
    k1, k2, _, _ = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
    with jax.enable_x64(False):
        jexp = jax_build(JAX_CONFIGS["cartpole_batch_sqp"], dtype=f32)
        spec = jexp["env"].spec
        draws = jax_batch_draws(cfg, lanes, f32, N_S, N_U)
        get_action = jax.jit(jexp["get_action_batch"])

        def first_step(m, x0):
            view = jgl.lane_shrink_to_bucket(jgl.lane_stack_ssm(m, lanes),
                                             n_free=cfg.n_steps)
            _, _, info = get_action(jexp["init_state_batch"](lanes), view,
                                    x0)
            return np.asarray(info["feasible"])

        jcli = _jax_first_fit(cfg, jexp, k2, [np.asarray(v) for v in
                                               _jax_cli_first_data(jexp, cfg)])
        x0 = spec.init_m + spec.init_std * jnp.asarray(draws["reset"][0])
        jf = first_step(jcli, x0)
        jfit = _jax_first_fit(cfg, jexp, k2, seed0)
        jf0 = first_step(jfit, jnp.asarray(x0_seed0.numpy()))
        jfit_np = jax_gpssm_to_numpy(jfit)
        jcli_np = jax_gpssm_to_numpy(jcli)
        x0 = np.asarray(x0)
    with jax.enable_x64(True):
        jexp64 = jax_build(JAX_CONFIGS["cartpole_batch_sqp"], dtype=F64)
        j64 = jax_gpssm_to_numpy(_jax_first_fit(cfg, jexp64, k2, seed0))

    def port_first_step(m, x0):
        view = tgl.lane_shrink_to_bucket(tgl.lane_stack_ssm(m, lanes),
                                         n_free=cfg.n_steps)
        _, _, info = texp["get_action_batch"](
            texp["init_state_batch"](lanes), view, x0)
        return info["feasible"].numpy()

    tm = gpssm_from_numpy(jcli_np, KT, device="cpu", dtype=torch.float32)
    tf = port_first_step(tm, torch.tensor(x0))
    print(f"full-width step 0 on JAX's model: JAX feasible {jf.mean()}, "
          f"port {tf.mean()}")
    np.testing.assert_array_equal(tf, jf)

    tfit = tssm_mod.calibrate_lipschitz(
        tssm_mod.ssm_fit(texp["make_ssm"](txs, tus, tr), iters=cfg.hyp_iters),
        tspec, n_region=640, draws=(d["region_x"], d["region_u"]))
    assert _rel(tfit.gp.log_noise.numpy(), jfit_np["log_noise"]) < 1e-4
    for d_ in range(N_S):
        assert _rel(tfit.gp.params[d_]["log_lengthscales"].numpy(),
                    jfit_np["params"][d_]["log_lengthscales"]) < 1e-2
    t64 = build_experiment(cfg, dtype=torch.float64, device="cpu")
    fit64 = tssm_mod.calibrate_lipschitz(
        tssm_mod.ssm_fit(t64["make_ssm"](*(_t(v) for v in seed0)),
                         iters=cfg.hyp_iters), t64["env"].spec, n_region=640,
        draws=tuple(_t(v) for v in jax_region(640, F64, N_S, N_U)))
    print(f"first fit on the seed-0 draws, l_mu: port f32 "
          f"{tfit.l_mu.tolist()}, JAX f32 {jfit_np['l_mu'].tolist()}, port "
          f"f64 {fit64.l_mu.tolist()}, JAX f64 {j64['l_mu'].tolist()}")
    assert _rel(fit64.gp.log_noise.numpy(), j64["log_noise"]) < 1e-8
    for d_ in range(N_S):
        assert _rel(fit64.gp.params[d_]["log_lengthscales"].numpy(),
                    j64["params"][d_]["log_lengthscales"]) < 1e-8
    assert _rel(fit64.l_mu.numpy(), j64["l_mu"]) < 1e-8
    assert _rel(fit64.l_sigma.numpy(), j64["l_sigma"]) < 1e-8

    tf0 = port_first_step(tfit, x0_seed0)
    print(f"full-width step 0 on the seed-0 draws, each package's own f32 "
          f"model: JAX feasible {jf0.mean()}, port {tf0.mean()}")
    np.testing.assert_array_equal(tf0, jf0)


@pytest.mark.slow
def test_cartpole_seed0_f32_lipschitz_matches_jax():
    """The f32 calibration of the cart-pole fleet's first model on
    chip_smoke's seed-0 draws (``-m slow``, ~2 min): the JAX package's f32
    fit and ``calibrate_lipschitz`` (its region draws), and the port's
    calibration of that same model on the same region draws: l_mu within
    1e-2. Open fault (ROADMAP Queue 3): the port gives the f64 answer of
    both packages (12.24 for the angular velocity), the JAX package in f32
    19.36, so this fails. It prints where: the JAX package's jitted
    Hessian norm of the angular velocity's mean at each training input
    (the buffer probes), in f32 and on the same model cast to f64, at the
    probes where the two differ most."""
    cfg, texp, _, txs, tus, tr = _seed0_first_data(torch.float32)
    k2 = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)[1]

    def hess_norms(ssm, z):
        def one(zz):
            h = jax.hessian(lambda q: ssm.predict_latent(q)[0][N_S - 1])(zz)
            return jnp.max(jnp.abs(jnp.linalg.eigvalsh(h)))

        return np.asarray(jax.jit(jax.vmap(one))(z))

    with jax.enable_x64(False):
        jexp = jax_build(JAX_CONFIGS["cartpole_batch_sqp"], dtype=jnp.float32)
        jm = _jax_first_fit(cfg, jexp, k2, [v.numpy() for v in (txs, tus,
                                                                 tr)])
        jfit = jax_gpssm_to_numpy(jm)
        region = jax_region(640, jnp.float32, N_S, N_U)
        probes = jssm_mod.ssm_probe_points(jm)
        h32 = hess_norms(jm, probes)
    m64 = jax.tree_util.tree_map(
        lambda v: v.astype(F64) if hasattr(v, "dtype")
        and jnp.issubdtype(v.dtype, jnp.floating) else v, jm)
    h64 = hess_norms(m64, probes.astype(F64))
    worst = np.argsort(-np.abs(h32 - h64))[:3]
    print("JAX's Hessian norm of the angular velocity's mean at training "
          "inputs, f32 vs f64: " + ", ".join(
              f"probe {i}: {h32[i]:.4f} vs {h64[i]:.4f}" for i in worst)
          + f"; 1.2 x max: {1.2 * h32.max():.4f} vs {1.2 * h64.max():.4f}")
    tm = gpssm_from_numpy(jfit, KT, device="cpu", dtype=torch.float32)
    tcal = tssm_mod.calibrate_lipschitz(
        tm, texp["env"].spec, n_region=640,
        draws=tuple(torch.tensor(v) for v in region))
    print(f"f32 l_mu on JAX's model and region draws: port "
          f"{tcal.l_mu.tolist()}, JAX {jfit['l_mu'].tolist()}")
    assert _rel(tcal.l_mu.numpy(), jfit["l_mu"]) < 1e-2
