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
from test_torch_bridge import (  # noqa: E402,F401
    jax_gpssm_to_numpy,
    jax_init_draws as _jax_init_draws,
    jax_region as _jax_region,
    one_torch_thread,
)

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


def _jax_draws(key, n_it, shape, dtype=F64):
    return np.stack([np.asarray(jax.random.normal(k, shape, dtype))
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


def _jax_run_draws(cfg, dtype=F64) -> dict:
    """The JAX runner's draws in ``dtype``, rebuilt from its key splits
    (runtime/episode.py: run_episodic, collect_initial_data,
    rollout_episode; cem_plan's per-iteration keys; calibrate_lipschitz's
    PRNGKey(0))."""
    key = jax.random.PRNGKey(cfg.seed)
    k_init, _, key = jax.random.split(key, 3)
    draws = _jax_init_draws(k_init, cfg.n_init_samples, dtype)
    draws["region_x"], draws["region_u"] = _jax_region(N_REGION, dtype)
    reset, plan, step = [], [], []
    for _ in range(cfg.n_ep):
        k_reset, k_roll, key = jax.random.split(key, 3)
        reset.append(np.asarray(jax.random.normal(k_reset, (2,), dtype)))
        pl, st = [], []
        for k in jax.random.split(k_roll, cfg.n_steps):
            k_plan, k_step = jax.random.split(k)
            pl.append(_jax_draws(k_plan, cfg.cem_iterations,
                                 (cfg.cem_samples, cfg.n_safe, 1), dtype))
            st.append(np.asarray(jax.random.normal(k_step, (2,), dtype)))
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


RUN_B_SET = ["n_max=2048", "n_init_samples=1024", "hyp_iters=60", "n_ep=1"]


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_b_first_episode_matches_jax_with_its_draws(monkeypatch, dtype):
    """Episodic run (b), ``pendulum_episode --set n_max=2048
    n_init_samples=1024 hyp_iters=60``: the build (1,024 initial points, the
    fit, the Lipschitz calibration) and the first episode on the CPU, the
    port fed the JAX runner's draws in ``dtype``: the per-step feasibility
    flags and the episode's counts equal. Minutes of CPU time, so outside
    tier-1 (``-m slow`` runs it); no refit or fit after the episode
    (opt_hyp_every 0 on both sides).

    float64 passes. float32 fails, ROADMAP Queue 3's open fault: the l_mu
    estimates now agree (the self-distance at a training input is exactly
    0 in both), but the f32 posterior variance at n = 1,024 cancels below
    its rounding, and the two packages' tubes part from the first steps.
    The test prints, for the model JAX hands to the episode, both
    packages' l_mu over the buffer and over the region probes."""
    from safe_exploration_tpu.runtime import episode as jep
    from safe_exploration_tpu_torch.runtime import episode as tep

    jdt, tdt = {"float64": (F64, torch.float64),
                "float32": (jnp.float32, torch.float32)}[dtype]
    flags, models = {}, {}
    jax_rollout, port_rollout = jep.rollout_episode, tep.rollout_episode
    jax_bucketed = jssm_mod.ssm_bucketed

    def jax_recorded(*args, **kwargs):
        traj, mstate, x = jax_rollout(*args, **kwargs)
        jax.debug.callback(
            lambda f: flags.__setitem__("jax", np.asarray(f)), traj["feasible"])
        return traj, mstate, x

    def port_recorded(*args, **kwargs):
        out = port_rollout(*args, **kwargs)
        flags["port"] = out[0]["feasible"].cpu().numpy()
        return out

    def jax_model(ssm):
        models["jax"] = ssm
        return jax_bucketed(ssm)

    monkeypatch.setattr(jep, "rollout_episode", jax_recorded)
    monkeypatch.setattr(tep, "rollout_episode", port_recorded)
    monkeypatch.setattr(jssm_mod, "ssm_bucketed", jax_model)
    cfg = _apply_overrides(CONFIGS["pendulum_episode"], RUN_B_SET)
    jexp = jax_build(dataclasses.replace(
        JAX_CONFIGS["pendulum_episode"], **dataclasses.asdict(cfg)),
        dtype=jdt)
    texp = build_experiment(cfg, dtype=tdt, device="cpu")
    common = dict(n_max=cfg.n_max, n_ep=cfg.n_ep, n_steps=cfg.n_steps,
                  n_init_samples=cfg.n_init_samples, hyp_iters=cfg.hyp_iters,
                  opt_hyp_every=0, kern_types=KT)
    ref = jep.run_episodic(
        jexp["env"], jexp["init_state"], jexp["get_action"], jexp["a"],
        jexp["b"], jexp["k_fb"], key=jax.random.PRNGKey(cfg.seed),
        l_mu=jexp["l_mu"], l_sigma=jexp["l_sigma"],
        make_ssm=jexp["make_ssm"], **common)["series"]
    out = run_episodic(
        texp["env"], texp["init_state"], texp["get_action"], texp["a"],
        texp["b"], texp["k_fb"], l_mu=texp["l_mu"], l_sigma=texp["l_sigma"],
        make_ssm=texp["make_ssm"], draws=_jax_run_draws(cfg, jdt),
        plan_noise_shape=texp["planner_noise_shape"], **common)["series"]
    jm = models["jax"]
    tm = gpssm_from_numpy(jax_gpssm_to_numpy(jm), KT, device="cpu",
                          dtype=tdt)
    probes = {"buffer": jssm_mod.ssm_probe_points(jm),
              "region": jssm_mod.lipschitz_probe_set(
                  jexp["env"].spec, jax.random.PRNGKey(0), N_REGION)}
    for name, z in probes.items():
        je = jax.jit(lambda s, p: jssm_mod.estimate_lipschitz(
            s, p, factor=1.2))(jm, z)
        te = tssm_mod.estimate_lipschitz(
            tm, torch.tensor(np.asarray(z), dtype=tdt), factor=1.2)
        print(f"{dtype} l_mu over the {name} of JAX's model: JAX "
              f"{np.asarray(je.l_mu).tolist()}, port {te.l_mu.tolist()}")
    diff = np.flatnonzero(flags["port"] != flags["jax"])
    print(f"run (b), episode 1, {dtype}: JAX feasible steps "
          f"{np.flatnonzero(flags['jax']).tolist()}, port "
          f"{np.flatnonzero(flags['port']).tolist()}; series JAX {ref}, "
          f"port {out}")
    assert diff.size == 0, f"first differing step {diff[0]}"
    for k in ("violations", "feasibility_rate", "n_data"):
        assert out[k] == ref[k], k


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
