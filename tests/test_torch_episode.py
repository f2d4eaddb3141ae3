"""PyTorch port: the episodic closed loop against the JAX package, on the
CPU, in f64.

  * ``gp_refit`` at n_max 1040, the large-matrix tier (``cholesky_hbm``'s
    plain version), against the JAX refit: chol, beta and K^-1 at 1e-9;
  * ``gp_nll`` value and gradient at 1e-10, and 10 steps of ``gp_fit``
    (Adam in optax's order) with hyperparameters at 1e-8;
  * ``estimate_lipschitz`` off data at 1e-8, and ``calibrate_lipschitz`` on
    JAX's region probes;
  * the single-instance ``get_action`` on a success step and on a fallback
    step after it, fed the JAX planner's draws, at 1e-8;
  * ``collect_initial_data`` on JAX's draws at 1e-12;
  * the slice as a whole: ``run_experiment`` for 2 episodes of 4 steps (one
    all-fallback episode, one all-feasible), fed the JAX runner's draws
    rebuilt from its key splits: violations, feasibility_rate and n_data
    equal, model_error and mean_cost within 1e-6, final GP factors and
    hyperparameters within 1e-8;
  * ``main(... --device cpu)`` prints the JSON summary; the registry equals
    the JAX one; unported choices raise naming their ROADMAP item.

Shapes are small (n_max 16-64, M 16, 2 iterations).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from safe_exploration_tpu.models import gp as jgp  # noqa: E402
from safe_exploration_tpu.models import ssm as jssm_mod  # noqa: E402
from safe_exploration_tpu.runtime.config import (  # noqa: E402
    CONFIGS as JAX_CONFIGS,
    ExperimentConfig as JaxConfig,
    build_experiment as jax_build,
)
from safe_exploration_tpu.runtime.episode import (  # noqa: E402
    collect_initial_data as jax_collect,
)
from safe_exploration_tpu.runtime.main import (  # noqa: E402
    run_experiment as jax_run_experiment,
)
from safe_exploration_tpu_torch.models import gp as tgp  # noqa: E402
from safe_exploration_tpu_torch.models import ssm as tssm_mod  # noqa: E402
from safe_exploration_tpu_torch.models.convert import gpssm_from_numpy  # noqa: E402
from safe_exploration_tpu_torch.runtime.config import (  # noqa: E402
    CONFIGS,
    ExperimentConfig,
    build_experiment,
)
from safe_exploration_tpu_torch.runtime.episode import (  # noqa: E402
    collect_initial_data,
    run_episodic,
)
from safe_exploration_tpu_torch.runtime.main import (  # noqa: E402
    _apply_overrides,
    main,
    run_experiment,
)
from test_torch_bridge import jax_gpssm_to_numpy, one_torch_thread  # noqa: E402,F401

F64 = jnp.float64
KT = ("rbf", "rbf")
N_REGION = 384   # 128 d_in probes of the operating region (pendulum d_in 3)


@pytest.fixture(scope="module")
def pendulum():
    """The default configuration built by both packages (f64)."""
    return (jax_build(JaxConfig(), dtype=F64),
            build_experiment(ExperimentConfig(), dtype=torch.float64,
                             device="cpu"))


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
    return ([{"log_lengthscales": rng.normal(0.0, 0.3, 3),
              "log_sf": np.array(-1.0 + 0.2 * d)} for d in range(2)],
            np.array([-2.5, -2.8]))


def _gps(n, n_max, params=None):
    """The same GP built by both packages (f64)."""
    x, y = _data(n)
    jp = tp = None
    if params is not None:
        jp = tuple({k: jnp.asarray(v) for k, v in p.items()} for p in params)
        tp = tuple({k: _t(v) for k, v in p.items()} for p in params)
    jg = jgp.gp_init(KT, jnp.asarray(x), jnp.asarray(y), n_max=n_max,
                     log_noise=-3.0, params=jp)
    tg = tgp.gp_init(KT, _t(x), _t(y), n_max=n_max, log_noise=-3.0, params=tp)
    return jg, tg


def _assert_factors(tg, jg, tol):
    for f in ("chol", "beta", "kinv"):
        assert _rel(getattr(tg, f).numpy(), getattr(jg, f)) < tol, f


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


def _jax_region(n, dtype=F64):
    kx, ku = jax.random.split(jax.random.PRNGKey(0))
    return (np.asarray(jax.random.uniform(kx, (n, 2), dtype)),
            np.asarray(jax.random.uniform(ku, (n, 1), dtype)))


def test_lipschitz_estimates_match_jax(pendulum):
    """estimate_lipschitz at off-data points against the JAX estimate
    (jitted) at 1e-8, and calibrate_lipschitz as that estimate over the
    training buffer plus the region probes of JAX's PRNGKey(0).

    Off data only: at a training input the self-distance |z - x_i|^2 is 0
    up to rounding, and the Hessian keeps that point's own curvature or
    drops it as the rounding falls (the floor at 0 has derivative 0 below,
    1/2 at, 1 above the tie), in JAX as in the port."""
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


def _jax_draws(key, n_it, shape):
    return np.stack([np.asarray(jax.random.normal(k, shape, F64))
                     for k in jax.random.split(key, n_it)])


def test_get_action_success_then_fallback_match_jax():
    """One feasible solve (the stored plan is set), then a solve from a
    state the tube cannot hold (the stored plan's next stage is applied):
    u, feasibility and the new state at 1e-8."""
    kw = dict(n_safe=3, n_max=16, cem_samples=16, cem_elites=4,
              cem_iterations=2, l_mu=0.05, l_sigma=0.02, log_noise=-4.0)
    jexp = jax_build(JaxConfig(**kw), dtype=F64)
    texp = build_experiment(ExperimentConfig(**kw), dtype=torch.float64,
                            device="cpu")
    x, y = _data(12, seed=5)
    jssm = jexp["make_ssm"](jax.random.PRNGKey(0), jnp.asarray(x[:, :2]),
                           jnp.asarray(x[:, 2:]), jnp.asarray(0.1 * y))
    params = tuple({**p, "log_sf": jnp.asarray(-3.0, F64)}
                   for p in jssm.gp.params)
    jssm = jssm.replace(gp=jgp.gp_refit(jssm.gp.replace(params=params)))
    tssm = gpssm_from_numpy(jax_gpssm_to_numpy(jssm), KT, device="cpu")
    jst, tst = jexp["init_state"](), texp["init_state"]()
    get_action = jax.jit(jexp["get_action"])
    flags = []
    for k, x0 in enumerate(([0.05, -0.1], [0.3, 0.5])):
        key = jax.random.PRNGKey(10 + k)
        ju, jst, jinfo = get_action(key, jst, jssm, jnp.asarray(x0))
        tu, tst, tinfo = texp["get_action"](
            None, tst, tssm, _t(x0), noise=_t(_jax_draws(key, 2, (16, 3, 1))))
        flags.append(bool(jinfo["feasible"]))
        assert bool(tinfo["feasible"]) == flags[-1]
        assert _rel(tu.numpy(), ju) < 1e-8
        for f in ("k_ff_plan", "p_plan", "warm_mean"):
            assert _rel(getattr(tst, f).numpy(), getattr(jst, f)) < 1e-8, f
        assert int(tst.plan_idx) == int(jst.plan_idx)
        assert int(tst.n_fail) == int(jst.n_fail)
    assert flags == [True, False]


def _jax_init_draws(key, n):
    kx, ku, kn = jax.random.split(key, 3)
    return {
        "init_x": np.asarray(jax.random.uniform(kx, (n, 2), F64, -1.0, 1.0)),
        "init_u": np.asarray(jax.random.uniform(ku, (n, 1), F64, -1.0, 1.0)),
        "init_noise": np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (2,), F64))(
                jax.random.split(kn, n))),
    }


def test_collect_initial_data_matches_jax(pendulum):
    jexp, texp = pendulum
    key = jax.random.PRNGKey(7)
    ref = jax.jit(lambda k, a, b, k_fb: jax_collect(jexp["env"], k, 30, a, b,
                                                    k_fb))(
        key, jexp["a"], jexp["b"], jexp["k_fb"])
    out = collect_initial_data(texp["env"], 30, texp["a"], texp["b"],
                               texp["k_fb"],
                               draws={k: _t(v) for k, v in
                                      _jax_init_draws(key, 30).items()})
    for o, r in zip(out, ref):
        assert _rel(o.numpy(), r) < 1e-12


def _jax_run_draws(cfg) -> dict:
    """The JAX runner's draws, rebuilt from its key splits
    (runtime/episode.py: run_episodic, collect_initial_data,
    rollout_episode; cem_plan's per-iteration keys; calibrate_lipschitz's
    PRNGKey(0))."""
    key = jax.random.PRNGKey(cfg.seed)
    k_init, _, key = jax.random.split(key, 3)
    draws = _jax_init_draws(k_init, cfg.n_init_samples)
    draws["region_x"], draws["region_u"] = _jax_region(N_REGION)
    reset, plan, step = [], [], []
    for _ in range(cfg.n_ep):
        k_reset, k_roll, key = jax.random.split(key, 3)
        reset.append(np.asarray(jax.random.normal(k_reset, (2,), F64)))
        pl, st = [], []
        for k in jax.random.split(k_roll, cfg.n_steps):
            k_plan, k_step = jax.random.split(k)
            pl.append(_jax_draws(k_plan, cfg.cem_iterations,
                                 (cfg.cem_samples, cfg.n_safe, 1)))
            st.append(np.asarray(jax.random.normal(k_step, (2,), F64)))
        plan.append(np.stack(pl))
        step.append(np.stack(st))
    draws.update(reset=np.stack(reset), plan=np.stack(plan),
                 step=np.stack(step))
    return {k: _t(v) for k, v in draws.items()}


SLICE_SET = ["n_ep=2", "n_steps=4", "n_max=64", "hyp_iters=20",
             "n_init_samples=40", "cem_samples=16", "cem_elites=4",
             "cem_iterations=2"]


def test_run_experiment_matches_jax_with_its_draws(monkeypatch):
    """The whole slice: initial data, fit + Lipschitz calibration, two
    episodes of get_action / env_step on the bucketed model, an ssm_update
    and a fit after each, against the JAX runner (what its run_experiment
    runs, with the key of cfg.seed). Episode 1 falls back on every step,
    episode 2 is feasible on every step. The port's run_experiment gives
    the series, the run_episodic it calls the final model (l_mu is not
    compared: see test_lipschitz_estimates_match_jax)."""
    from safe_exploration_tpu.runtime.episode import (
        run_episodic as jax_run_episodic,
    )
    from safe_exploration_tpu_torch.runtime import episode as tep

    runs = []

    def recorded(*args, **kwargs):
        runs.append(run_episodic(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(tep, "run_episodic", recorded)

    cfg = _apply_overrides(CONFIGS["pendulum_episode"], SLICE_SET)
    jexp = jax_build(dataclasses.replace(
        JAX_CONFIGS["pendulum_episode"], **dataclasses.asdict(cfg)),
        dtype=F64)
    common = dict(n_max=cfg.n_max, n_ep=cfg.n_ep, n_steps=cfg.n_steps,
                  n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters)
    ref = jax_run_episodic(
        jexp["env"], jexp["init_state"], jexp["get_action"], jexp["a"],
        jexp["b"], jexp["k_fb"], key=jax.random.PRNGKey(cfg.seed),
        kern_types=KT, l_mu=jexp["l_mu"], l_sigma=jexp["l_sigma"],
        make_ssm=jexp["make_ssm"], **common)
    draws = _jax_run_draws(cfg)
    series = run_experiment(cfg, dtype=torch.float64, device="cpu",
                            draws=draws)["series"]
    rs = ref["series"]
    for k in ("violations", "feasibility_rate", "n_data"):
        assert series[k] == rs[k], k
    assert rs["feasibility_rate"] == [0.0, 1.0]
    assert rs["violations"] == [0, 0] and rs["n_data"] == [40, 44]
    for k in ("model_error", "mean_cost"):
        np.testing.assert_allclose(series[k], rs[k], rtol=1e-6, atol=0)
    (out,) = runs
    assert out["series"]["n_data"] == rs["n_data"]
    jg, tg = ref["ssm"].gp, out["ssm"].gp
    _assert_factors(tg, jg, 1e-8)
    assert _rel(tg.log_noise.numpy(), jg.log_noise) < 1e-8
    for d in range(2):
        assert _rel(tg.params[d]["log_lengthscales"].numpy(),
                    jg.params[d]["log_lengthscales"]) < 1e-8


def test_main_on_cpu_prints_the_summary(capsys):
    rc = main(["--config", "pendulum_episode", "--device", "cpu", "--set",
               "n_ep=1", "n_steps=2", "n_max=32", "n_init_samples=10",
               "hyp_iters=2", "cem_samples=8", "cem_elites=2",
               "cem_iterations=1"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == {"wall_time_s", "metrics", "series"}
    assert summary["series"]["n_data"] == [10]
    assert summary["series"]["violations"] == [0]
    assert np.isfinite(summary["series"]["model_error"]).all()


def test_registry_matches_jax_and_unported_choices_raise():
    assert set(CONFIGS) == set(JAX_CONFIGS)
    for name, cfg in CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JAX_CONFIGS[name]), name
    with pytest.raises(NotImplementedError, match="items 11"):
        build_experiment(CONFIGS["pendulum_episode_sparse"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        run_experiment(CONFIGS["pendulum_batch"], device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        run_experiment(CONFIGS["pendulum_serve"], device="cpu")
    exp = build_experiment(ExperimentConfig(n_max=16), dtype=torch.float64,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="item 12"):
        run_episodic(exp["env"], exp["init_state"], exp["get_action"],
                     exp["a"], exp["b"], exp["k_fb"], kern_types=KT,
                     n_max=16, l_mu=exp["l_mu"], l_sigma=exp["l_sigma"],
                     ckpt_dir="ckpt")
    sqp = build_experiment(ExperimentConfig(solver="sqp"),
                           dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        sqp["get_action"](None, sqp["init_state"](), None,
                          torch.zeros(2, dtype=torch.float64))
