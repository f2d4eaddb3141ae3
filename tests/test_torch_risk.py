"""PyTorch port: the risk-priced objective (``risk_tracking``: tracking plus
``w_sigma`` times the summed trace of the propagated covariance), against
the JAX package on the CPU in f64.

  * ``solvers/costs.risk_tracking_cost`` and the lane form
    ``sqp_lanes._cost_lanes("risk_tracking")``, with and without a perf
    trajectory (with none the price reads the safety tube's Q), at 1e-10;
  * the lane rollout's perf covariance recursion (``want_sigma``) on the
    JAX-fitted cfg2 state, both perf methods, on a shared and on per-lane
    models, at 1e-9;
  * the single-instance NLP: its closures with the risk objective (the
    perf trajectory's Sigma reaches ``cost_fn``) at 1e-10, and its solve
    against the JAX planner's at a small budget, where ``taylor`` and
    ``mean_equivalent`` give different plans (k_ff 1e-6);
  * the configuration: ``cartpole_risk_sqp`` builds, the lane solvers get
    ``w_sigma``, ``w_sigma`` is warned about where the JAX package warns,
    and the CLI runs it on ``--device cpu``.
"""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.envs import env_step as jax_env_step  # noqa: E402
from safe_exploration_tpu.models import make_gp_ssm as jax_make_gp_ssm  # noqa: E402
from safe_exploration_tpu.models.gp import gp_refit as jax_refit  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu.solvers import costs as jcosts  # noqa: E402
from safe_exploration_tpu.solvers import sqp_lanes as jl  # noqa: E402
from safe_exploration_tpu.solvers.sqp import SqpConfig as JaxSqpConfig  # noqa: E402
from safe_exploration_tpu_torch.models import gp_lanes as tgl  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.main import main  # noqa: E402
from safe_exploration_tpu_torch.solvers import costs as tcosts  # noqa: E402
from safe_exploration_tpu_torch.solvers import sqp_lanes as tl  # noqa: E402
from safe_exploration_tpu_torch.solvers.sqp import SqpConfig  # noqa: E402
from test_torch_bridge import (  # noqa: E402,F401
    check_nlp_closures,
    golden_problem,
    jax_gpssm_to_numpy,
    jit_once,
    one_torch_thread,
)
from test_torch_cartpole import _consts, _lane_models, golden  # noqa: E402,F401

F64 = jnp.float64


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


# ------------------------------------------------------------------ the cost


@pytest.mark.parametrize("n_perf", [0, 4])
def test_risk_tracking_cost_matches_jax(n_perf):
    """The functional on random trajectories, shapes (T, n) (T, n, n)
    (T, n) and controls, at 1e-10; the lane form on a random packed y (the
    tube's blocks, then with n_perf > 0 the perf means, variances and
    Sigma) at 1e-10 for 5 lanes: with n_perf == 0 it prices the tube's Q,
    with n_perf > 0 the perf Sigma, and w_sigma = 0 gives the tracking
    cost."""
    rng = np.random.default_rng(n_perf)
    n_s, n_u, t_len, r = 4, 1, 3, 2
    p, var = rng.standard_normal((2, 6, n_s))
    a = rng.standard_normal((6, n_s, n_s))
    q = a @ a.transpose(0, 2, 1)
    u = rng.standard_normal((6, n_u))
    target = rng.standard_normal(n_s)
    jf = jcosts.risk_tracking_cost(jnp.asarray(target), w_sigma=3.0)
    tf = tcosts.risk_tracking_cost(_t(target), w_sigma=3.0)
    ref = jf(*(jnp.asarray(v) for v in (p, q, var, u)))
    got = tf(*(_t(v) for v in (p, q, var, u)))
    assert got.shape == ()
    assert abs(float(got) - float(ref)) <= 1e-10 * abs(float(ref))

    n_var = (t_len + max(n_perf - r, 0)) * n_u
    ny = t_len * (2 * n_s + n_s * n_s) + n_perf * (2 * n_s + n_s * n_s)
    y = rng.standard_normal((ny, 5))
    uf = rng.standard_normal((n_var, 5))
    for w in (5.0, 0.0):
        args = {"target": target, "w_sigma": w}
        jc = jl._cost_lanes("risk_tracking",
                            {k: jnp.asarray(v) for k, v in args.items()},
                            jnp.asarray(y), jnp.asarray(uf), t_len, n_s, n_u,
                            n_perf=n_perf, r=r)
        tc = tl._cost_lanes("risk_tracking", {"target": _t(target),
                                              "w_sigma": w},
                            _t(y), _t(uf), t_len, n_s, n_u, n_perf=n_perf,
                            r=r)
        assert tc.shape == (5,)
        assert _rel(tc.numpy(), jc) < 1e-10
    track = tl._cost_lanes("tracking", {"target": _t(target)}, _t(y), _t(uf),
                           t_len, n_s, n_u, n_perf=n_perf, r=r)
    assert _rel(tc.numpy(), track.numpy()) < 1e-14
    assert tl._wants_sigma("risk_tracking", n_perf) == (n_perf > 0)


# ------------------------------------------- the lane covariance recursion


@pytest.mark.parametrize("which", ["shared", "per_lane"])
@pytest.mark.parametrize("method", ["taylor", "mean_equivalent"])
def test_lane_sigma_rollout_on_cartpole_matches_jax(golden, method, which):
    """On the JAX-fitted cfg2 state (test_torch_cartpole's ``golden``), n_safe
    3, n_perf 6, r 2 on 3 lanes: the packed y with the perf Sigma blocks
    (n_perf n_s^2 = 96 more rows) at 1e-9 against the JAX package's
    scalar recursion (run op by op), and the lane risk cost on it at
    1e-10; per-lane models (``_lane_models``: one lockstep append) carry
    their own noise into the diagonal."""
    jm, tm = ((golden["jssm"], golden["tssm"]) if which == "shared"
              else _lane_models(golden))
    k_fb, a, b, bmat = _consts(golden["jexp"])
    t_len, n_perf, r = 3, 6, 2
    rng = np.random.default_rng(6)
    x0 = rng.uniform(-0.05, 0.05, (4, 3))
    u = 0.2 * rng.standard_normal((t_len + n_perf - r, 3))
    jy = jl._rollout_y_lanes(
        jm, jnp.asarray(u), [jnp.asarray(row) for row in x0],
        *(jnp.asarray(v) for v in (k_fb, a, b)),
        JaxSqpConfig(n_safe=t_len, n_perf=n_perf, r_shared=r,
                     perf_method=method),
        jnp.asarray(bmat), r, 1, want_sigma=True)
    ty = tl._rollout_y_lanes(
        tm, _t(u), _t(x0), *(_t(v) for v in (k_fb, a, b)),
        SqpConfig(n_safe=t_len, n_perf=n_perf, r_shared=r,
                  perf_method=method), _t(bmat), r=r, want_sigma=True)
    assert ty.shape == jy.shape == (t_len * 24 + n_perf * 24, 3)
    assert _rel(ty.numpy(), jy) < 1e-9
    args = {"target": np.full(4, 0.01), "w_sigma": 5.0}
    jc = jl._cost_lanes("risk_tracking",
                        {k: jnp.asarray(v) for k, v in args.items()}, jy,
                        jnp.asarray(u), t_len, 4, 1, n_perf=n_perf, r=r)
    tc = tl._cost_lanes("risk_tracking", {"target": _t(args["target"]),
                                          "w_sigma": 5.0},
                        ty, _t(u), t_len, 4, 1, n_perf=n_perf, r=r)
    assert _rel(tc.numpy(), jc) < 1e-10


# ------------------------------------------------- the single-instance NLP


def _pendulum_risk(method, **kw):
    """The JAX package's perf-trajectory test instance
    (tests/test_perf_trajectory_sqp.py::_calibrated_ssm: 12 JAX-drawn
    pendulum points, raw inputs, log noise -4, log_sf -3) under the risk
    objective, built by both packages."""
    cfg = dict(solver="sqp", objective="risk_tracking", w_sigma=25.0,
               n_safe=3, n_perf=6, r_shared=2, n_max=32,
               perf_trajectory=method, **kw)
    jexp = jax_build(JaxConfig(**cfg), dtype=F64)
    texp = build_experiment(ExperimentConfig(**cfg), dtype=torch.float64,
                            device="cpu")
    env, a, b = jexp["env"], jexp["a"], jexp["b"]
    key = jax.random.PRNGKey(0)
    xs = (jax.random.uniform(key, (12, 2), F64, -1.0, 1.0)
          * jnp.asarray([0.3, 1.0], F64))
    us = jax.random.uniform(jax.random.fold_in(key, 1), (12, 1), F64, -1.0,
                            1.0)
    _, x_next = jax.vmap(lambda x, u: jax_env_step(env, key, x, u))(xs, us)
    jssm = jax_make_gp_ssm(
        jexp["kern_types"], xs, us, x_next - (xs @ a.T + us @ b.T), n_max=32,
        l_mu=jnp.full((2,), 0.05, F64), l_sigma=jnp.full((2,), 0.02, F64),
        log_noise=-4.0)
    params = tuple({**p, "log_sf": jnp.asarray(-3.0, F64)}
                   for p in jssm.gp.params)
    jssm = jssm.replace(gp=jax_refit(jssm.gp.replace(params=params)))
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(jssm), ("rbf", "rbf"),
                            device="cpu")
    return jexp, texp, jssm, tssm


def test_nlp_closures_price_the_perf_covariance():
    """The NLP's closures under the risk objective (``taylor``) against the
    JAX package's at 1e-10 (test_torch_bridge.check_nlp_closures: the
    objective reads the perf trajectory's Sigma through ``cost_fn``); the
    port's objective moves with w_sigma and differs between the methods."""
    jexp, texp, jssm, tssm = _pendulum_risk("taylor")
    x0 = np.asarray([0.05, 0.1])
    check_nlp_closures(jexp, jssm, texp, tssm, x0, n_safe=3, n_perf=6,
                       r_shared=2)
    from safe_exploration_tpu_torch.solvers import sqp as tsqp

    u = 0.1 * torch.ones(7, dtype=torch.float64)
    vals = {}
    for method in ("taylor", "mean_equivalent"):
        for w in (25.0, 0.0):
            cfg = tsqp.SqpConfig(n_safe=3, n_perf=6, r_shared=2,
                                 perf_method=method)
            spec = texp["env"].spec
            obj = tsqp._build_constraint_fn(
                tssm, _t(x0), texp["k_fb"].expand(3, 1, 2), texp["a"],
                texp["b"], cfg, spec.h_mat_obs, spec.h_obs, spec.h_mat_safe,
                spec.h_safe,
                tcosts.risk_tracking_cost(spec.target, w_sigma=w))[0]
            vals[method, w] = float(obj(u))
    for method in ("taylor", "mean_equivalent"):
        assert vals[method, 25.0] - vals[method, 0.0] > 1e-6
    assert vals["taylor", 0.0] == vals["mean_equivalent", 0.0]
    assert abs(vals["taylor", 25.0] - vals["mean_equivalent", 25.0]) > 1e-10


@pytest.fixture(scope="module")
def nlp_solves():
    """Each perf method's solve at a 6 x 4 + 3 budget by both packages from
    the same start (the JAX planner compiled once per method)."""
    out = {}
    x0 = np.asarray([0.05, 0.1])
    for method in ("taylor", "mean_equivalent"):
        jexp, texp, jssm, tssm = _pendulum_risk(
            method, sqp_outer=6, sqp_inner=4)
        warm = np.zeros((7, 1))

        def solve(x, w, jexp=jexp, jssm=jssm):
            return jexp["planner"](jax.random.PRNGKey(0), jssm, x, w)

        ref = jit_once(solve, jnp.asarray(x0), jnp.asarray(warm))(
            jnp.asarray(x0), jnp.asarray(warm))
        got = texp["planner"](None, tssm, _t(x0), _t(warm))
        out[method] = (ref, got)
    return out


@pytest.mark.parametrize("method", ["taylor", "mean_equivalent"])
def test_nlp_risk_solve_matches_jax(nlp_solves, method):
    """The planner under the risk objective (w_sigma 25, n_safe 3 +
    n_perf 6, r 2): feasible as JAX's, k_ff and the whole decision matrix
    at 1e-6, cost at 1e-6; the two methods' plans and costs differ by more
    than 1e-9 in both packages (tests/test_perf_trajectory_sqp.py::
    test_risk_cost_taylor_vs_mean_equivalent_solve_differently)."""
    (jk, jf, jv, ji), (tk, tf, tv, ti) = nlp_solves[method]
    assert bool(tf) == bool(jf) and bool(jf)
    assert _rel(tk.numpy(), jk) < 1e-6
    assert _rel(ti["warm_next"].numpy(), ji["warm_next"]) < 1e-6
    assert abs(float(ti["cost"]) - float(ji["cost"])) <= 1e-6 * abs(
        float(ji["cost"]))
    other = nlp_solves[{"taylor": "mean_equivalent",
                        "mean_equivalent": "taylor"}[method]]
    for (ref_k, *_, ref_i), (got_k, *_, got_i) in zip(nlp_solves[method],
                                                     other):
        assert float(np.max(np.abs(np.asarray(ref_i["warm_next"])
                                   - np.asarray(got_i["warm_next"])))) > 1e-9
        assert abs(float(ref_i["cost"]) - float(got_i["cost"])) > 1e-9


# -------------------------------------------------------- the configuration


def test_cartpole_risk_config_wiring_and_warnings():
    """``cartpole_risk_sqp`` equals the JAX entry and builds; its cost is
    the risk functional with w_sigma 5 and its lane solvers take it (the
    lane SQP and CEM support the objective); ``w_sigma`` away from its
    default is warned about exactly where the JAX package warns (any
    other objective), and the lane cost gets w_sigma only for the risk
    objective."""
    cfg = CONFIGS["cartpole_risk_sqp"]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JAX_CONFIGS["cartpole_risk_sqp"])
    texp = build_experiment(cfg, dtype=torch.float64, device="cpu")
    assert tl.lanes_supported(
        tgl.lane_stack_ssm(_tiny_ssm(texp), 2),
        SqpConfig(n_safe=cfg.n_safe, n_perf=cfg.n_perf,
                  r_shared=cfg.r_shared), cfg.objective)
    p = torch.zeros((10, 4), dtype=torch.float64)
    sig = torch.eye(4, dtype=torch.float64).expand(10, 4, 4)
    u = torch.zeros((10, 1), dtype=torch.float64)
    assert float(texp["cost_fn"](p, sig, p, u)) == pytest.approx(
        5.0 * 40.0, rel=1e-14)
    for objective, warns in (("tracking", True), ("exploration", True),
                             ("risk_tracking", False)):
        kw = dict(env="cartpole", kern_types=("rbf",), solver="sqp",
                  objective=objective, w_sigma=2.0)
        seen = {}
        for name, build, conf in (
                ("jax", lambda c: jax_build(c, dtype=F64), JaxConfig(**kw)),
                ("port", lambda c: build_experiment(
                    c, dtype=torch.float64, device="cpu"),
                 ExperimentConfig(**kw))):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                build(conf)
            seen[name] = any("w_sigma" in str(w.message) for w in rec)
        assert seen == {"jax": warns, "port": warns}, objective


def _tiny_ssm(texp):
    rng = np.random.default_rng(0)
    xs = _t(rng.uniform(-0.1, 0.1, (6, 4)))
    us = _t(rng.uniform(-0.5, 0.5, (6, 1)))
    return texp["make_ssm"](xs, us, 0.01 * xs)


def test_cartpole_risk_cli_on_cpu(capsys):
    """``runtime.main --config cartpole_risk_sqp --device cpu`` at a tiny
    size (1 episode of 1 step, n_max 16, a 1 x 1 budget): the JAX CLI's
    episodic keys, 0 violations, n_data as scheduled, finite errors."""
    rc = main(["--config", "cartpole_risk_sqp", "--device", "cpu", "--set",
               "n_ep=1", "n_steps=1", "n_max=16", "n_init_samples=8",
               "hyp_iters=2", "sqp_outer=1", "sqp_inner=1"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == {"wall_time_s", "metrics", "series"}
    series = summary["series"]
    assert set(series) == {"violations", "feasibility_rate", "model_error",
                           "mean_cost", "episode_time_s", "n_data"}
    assert series["violations"] == [0] and series["n_data"] == [8]
    assert np.isfinite(series["model_error"]).all()
